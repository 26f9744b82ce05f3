"""Declarative Session facade: one object from job spec to trained model.

Counterpart of ``repro.api.session``::

    from repro_torch.api import JobConfig, Session

    sess = Session(JobConfig(arch="granite-3-2b", algo="dreamddp",
                             workers=8, period=5, bandwidth=1e9))
    sess.fit(100)                      # profile -> plan -> train
    sess.replan(bandwidth=1e8)         # link drifted: re-solve + hot-swap
    sess.fit(100)                      # continue on the new schedule

    engine = sess.serve()              # a ServeEngine over worker 0
    engine.generate(tokens, 16)
    sess.simulate("churn")             # replay the plan through SimNet

Everything is lazy: ``.plan`` / ``.profile()`` work without ever building
training state, and ``.fit`` builds the runner on first call.  Training
and serving run on the GPU unless the session is made with
``device="cpu"``.  With ``ckpt_dir`` (or a ``ckpt=`` manager) the runner
saves every ``ckpt_every`` steps and restarts from the last checkpoint
after a failure; :meth:`Session.restore` resumes a session from one.

With ``async_mode`` or an ``async_runtime`` strategy (``hier-async``)
``fit`` runs the async two-tier runtime (:mod:`repro_torch.hier`):
workers train whole periods on their own virtual clocks and push
layer-wise deltas to a server tier that merges them with staleness-aware
momentum; the trained artifact is the global model.
:meth:`Session.simulate` replays the plan through SimNet
(:mod:`repro_torch.sim`) without building any training state.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Any

import torch

from ..checkpoint import CheckpointManager
from ..core.partial_sync import worker_unstack
from ..core.plans import SyncPlan
from ..core.profiler import HardwareSpec, LayerProfile, analytic_profile
from ..data import MarkovCorpus
from ..device import resolve_device
from ..optim import make_optimizer
from ..runtime import (Runner, RunnerConfig, StepConfig, TrainState,
                       init_train_state)
from ..runtime.runner import reshard_train_state
from ..runtime.step import prefix_len
from ..serve import EngineConfig, ServeEngine
from ..tree import tree_map
from .registry import get_strategy

__all__ = ["JobConfig", "Session", "InferenceSession"]

Tree = Any


@dataclass(frozen=True)
class JobConfig:
    """Declarative description of one training job (pure data; the
    reference's fields and defaults)."""

    arch: str = "granite-3-2b"
    algo: str = "dreamddp"
    workers: int = 8
    period: int = 5                    # H, iterations per sync period
    bandwidth: float = 1e9             # bytes/s on the sync (slow/geo) axis
    latency: float = 5e-4
    chips_per_worker: int = 1
    batch_per_worker: int = 4
    seq: int = 64
    smoke: bool = True                 # reduced same-family config
    optimizer: str = "adam"
    lr: float = 3e-3
    warmup_steps: int = 10
    decay_steps: int = 400
    weight_decay: float = 0.0
    n_microbatches: int = 1
    compress: str | None = None        # None | "int8_ef" (legacy flag)
    outer: bool = False                # DiLoCo outer optimizer (legacy flag)
    track_divergence: bool = False
    fill_mode: str = "exact"
    seed: int = 0
    ckpt_dir: str | None = None
    ckpt_every: int = 200
    # period-fused training: whole H-step periods with one device
    # synchronize per period, staged data and device-resident metrics
    fused_period: bool = True
    period_exec: str = "pipeline"
    prefetch_depth: int = 1
    prefetch_background: bool = False
    # asynchronous two-tier execution (repro_torch.hier): workers run
    # H-step periods on their own clocks and push layer-wise deltas to a
    # server tier that merges them with staleness-aware momentum — no
    # period-boundary barrier.  Also switched on by strategies that set
    # ``async_runtime`` (e.g. ``algo="hier-async"``).
    async_mode: bool = False
    merge_rule: str = "halos"          # "halos" | "delayed-nesterov"
    staleness_beta: float = 0.9
    merge_lr: float | None = None      # None -> 1/workers (worker mean)
    merge_momentum: float = 0.9
    max_staleness: int = 8
    pushes_per_merge: int = 1

    def replace(self, **kw) -> "JobConfig":
        return dataclasses.replace(self, **kw)


class Session:
    """Facade over profile -> schedule -> phase steps -> runner.

    ``model`` / ``data`` keyword overrides replace the pieces the config
    would otherwise build (a custom model with ``layer_costs`` /
    ``unit_layout`` / ``loss``, or another data source with
    ``batch(step)``; ``ckpt`` a :class:`CheckpointManager` in place of
    one over ``cfg.ckpt_dir``).  ``params`` (an unstacked tree, e.g. the
    JAX package's parameters through
    ``repro_torch.convert.params_from_numpy``) replaces the initial
    parameters ``model.init`` would draw from ``cfg.seed``.  ``device``
    is where training runs: the GPU by default (raising without one),
    the CPU only when asked for.

    In async mode :attr:`state` holds the global model broadcast to the
    worker-stacked view, with no optimizer state: each worker's state
    lives in the runner (the reference also keeps a W-worker initial
    state there, which at full width would cost a fourth copy of the
    workers' states).
    """

    def __init__(self, cfg: JobConfig, *, model: Any = None,
                 data: Any = None, ckpt: CheckpointManager | None = None,
                 params: Tree | None = None,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self._ckpt = ckpt
        self._params = params
        self.device = resolve_device(device)
        self.strategy = get_strategy(cfg.algo)
        self._model = model
        self._frontend: str | None = None
        self._data = data
        self._owns_data = data is None
        self._profile: LayerProfile | None = None
        self._plan: SyncPlan | None = None
        self._opt = None
        self._runner: Any = None            # Runner or AsyncHierRunner
        self._state: TrainState | None = None
        self._step = 0
        self._engines: dict[tuple, ServeEngine] = {}

    # ------------------------------------------------------------ lazy parts
    @property
    def model(self):
        if self._model is None:
            from ..configs import get_arch
            arch = get_arch(self.cfg.arch)
            self._model = (arch.make_smoke() if self.cfg.smoke
                           else arch.make_model())
            self._frontend = arch.frontend
        return self._model

    @property
    def hardware(self) -> HardwareSpec:
        return HardwareSpec(bandwidth=self.cfg.bandwidth,
                            latency=self.cfg.latency,
                            n_workers=self.cfg.workers,
                            chips_per_worker=self.cfg.chips_per_worker)

    def profile(self, *, refresh: bool = False) -> LayerProfile:
        """The layer-wise comm/compute profile the scheduler consumes."""
        if self._profile is None or refresh:
            costs = self.model.layer_costs(self.cfg.batch_per_worker,
                                           self.cfg.seq)
            self._profile = analytic_profile(costs, self.hardware)
        return self._profile

    @property
    def plan(self) -> SyncPlan:
        """The strategy's SyncPlan (built on first access)."""
        if self._plan is None:
            self._plan = self.strategy.build_plan(
                self.profile(), self.cfg.period,
                fill_mode=self.cfg.fill_mode)
        return self._plan

    @property
    def step_config(self) -> StepConfig:
        if self.cfg.compress is not None or self.cfg.outer:
            warnings.warn(
                "JobConfig.compress/outer are deprecated; pick the policy "
                "through the algo registry instead (algo='dreamddp-int8' "
                "for int8+EF syncs, or a strategy whose sync_policy() "
                "returns OuterOptSync for the DiLoCo outer step)",
                DeprecationWarning, stacklevel=2)
        base = StepConfig(n_microbatches=self.cfg.n_microbatches,
                          compress=self.cfg.compress, outer=self.cfg.outer,
                          track_divergence=self.cfg.track_divergence)
        # once the strategy has resolved a policy the legacy flags have
        # done their job — stop threading them through the step config
        return dataclasses.replace(
            base, policy=self.strategy.sync_policy(base), compress=None,
            outer=False)

    # ----------------------------------------------------------- async parts
    @property
    def use_async(self) -> bool:
        """Whether training runs on the async two-tier runtime."""
        return bool(self.cfg.async_mode
                    or getattr(self.strategy, "async_runtime", False))

    @property
    def merge_config(self):
        from ..hier import MergeConfig
        cfg = self.cfg
        return MergeConfig(rule=cfg.merge_rule, lr=cfg.merge_lr,
                           momentum=cfg.merge_momentum,
                           staleness_beta=cfg.staleness_beta,
                           max_staleness=cfg.max_staleness)

    @property
    def async_config(self):
        from ..hier import AsyncConfig
        return AsyncConfig(pushes_per_merge=self.cfg.pushes_per_merge,
                           merge=self.merge_config)

    def _static_scenario(self):
        """The implicit static single-DC scenario a plain async ``fit``
        runs against (the JobConfig link, no events)."""
        from ..sim.network import LinkSpec
        from ..sim.scenarios import Scenario
        cfg = self.cfg
        return Scenario(
            name="static", description="static cluster from JobConfig",
            n_workers=cfg.workers, n_datacenters=1,
            intra=LinkSpec(bandwidth=cfg.bandwidth, latency=cfg.latency,
                           jitter=0.0),
            inter=None, drift={}, events=(), periods=1, seed=cfg.seed)

    @property
    def state(self) -> TrainState:
        self._ensure_built()
        return self._state

    @property
    def history(self) -> list[dict]:
        return self._runner.history if self._runner is not None else []

    @property
    def runner(self):
        """The :class:`Runner` (sync) or
        :class:`~repro_torch.hier.AsyncHierRunner` (async)."""
        self._ensure_built()
        return self._runner

    # -------------------------------------------------------------- training
    def _make_data(self):
        # batches are built on the host; the runner stages them onto the
        # device (through pinned memory in the compiled mode)
        return MarkovCorpus(vocab=self.model.cfg.vocab,
                            seq_len=self.cfg.seq,
                            batch_per_worker=self.cfg.batch_per_worker,
                            n_workers=self.cfg.workers, seed=self.cfg.seed)

    def _ensure_built(self) -> None:
        if self._runner is not None:
            return
        cfg = self.cfg
        scfg = self.step_config
        opt_kw = dict(lr=cfg.lr, warmup_steps=cfg.warmup_steps,
                      decay_steps=cfg.decay_steps)
        if cfg.weight_decay:
            opt_kw["weight_decay"] = cfg.weight_decay
        self._opt = make_optimizer(cfg.optimizer, **opt_kw)
        if self._data is None:
            self._data = self._make_data()
        if self._ckpt is None and cfg.ckpt_dir:
            self._ckpt = CheckpointManager(cfg.ckpt_dir)
        if self.use_async:
            from ..hier import AsyncHierRunner, AsyncRunnerConfig
            self._runner = AsyncHierRunner(
                self.model, self._opt, self.strategy, self._data,
                profile=self.profile(), scenario=self._static_scenario(),
                H=cfg.period, step_cfg=scfg,
                run_cfg=AsyncRunnerConfig(
                    async_cfg=self.async_config,
                    ckpt_every_merges=(cfg.ckpt_every
                                       if self._ckpt is not None else 0),
                    fill_mode=cfg.fill_mode),
                ckpt=self._ckpt, seed=cfg.seed, params=self._params,
                device=self.device)
            self._state = TrainState(
                self._runner.stacked_params(cfg.workers), None,
                torch.zeros((), dtype=torch.int32, device=self.device))
            return
        gen = torch.Generator(self.device).manual_seed(cfg.seed)
        self._state = init_train_state(self.model, self._opt, gen,
                                       cfg.workers, cfg=scfg,
                                       params=self._params)
        self._runner = Runner(self.model, self._opt, self.plan, self._data,
                              ckpt=self._ckpt, step_cfg=scfg,
                              run_cfg=RunnerConfig(
                                  ckpt_every=cfg.ckpt_every,
                                  fused_period=cfg.fused_period,
                                  period_exec=cfg.period_exec,
                                  prefetch_depth=cfg.prefetch_depth,
                                  prefetch_background=(
                                      cfg.prefetch_background)))

    def fit(self, steps: int) -> "Session":
        """Train for ``steps`` iterations (resumable; history accumulates).

        With ``JobConfig.fused_period`` (the default) whole H-step
        periods run with a single device synchronize each — data staged
        one period ahead, metrics drained every ``log_every`` periods —
        and partial periods (a ``replan()`` landing mid-period) on the
        per-step path.  ``fused_period=False`` forces the per-step path.

        Under the async runtime (``async_mode`` or an ``async_runtime``
        strategy like ``hier-async``) ``steps`` must be a whole number
        of periods; workers run them on their own virtual clocks and the
        trained artifact is the global server model, broadcast back into
        the worker-stacked ``state`` view for ``serve()``.  The async op
        log is a deterministic function of the total period count, so a
        session runs exactly one async timeline — call ``fit`` once (or,
        after :meth:`restore`, once more with the same total).
        """
        self._ensure_built()
        if self.use_async:
            H = self.cfg.period
            if steps % H:
                raise ValueError(
                    f"async fit advances whole periods: steps={steps} is "
                    f"not a multiple of H={H}")
            self._runner.run((self._step + steps) // H)
            self._step += steps
            self._state = self._state._replace(
                params=self._runner.stacked_params(self.cfg.workers))
            return self
        self._state = self._runner.run(self._state, steps,
                                       start_step=self._step)
        self._step += steps
        return self

    def restore(self, step: int | None = None) -> int:
        """Resume from a checkpoint of this session's manager (the latest
        by default): the state is loaded in place and ``fit`` continues
        from its step, which is returned.

        In async mode the runner restores its merge-boundary checkpoint
        (workers, server, in-flight deltas, op cursor) and the global
        version is returned; ``fit`` with the interrupted run's total
        then replays the rest of its timeline."""
        self._ensure_built()
        if self._ckpt is None:
            raise ValueError("restore() needs a session made with ckpt_dir "
                             "or ckpt=")
        if self.use_async:
            version = self._runner.restore(step)
            self._state = self._state._replace(
                params=self._runner.stacked_params(self.cfg.workers))
            return version
        self._step, _, _ = self._ckpt.restore(self._state, step=step,
                                              in_place=True)
        return self._step

    # ------------------------------------------------------------- replan
    def replan(self, *, bandwidth: float | None = None,
               latency: float | None = None, workers: int | None = None,
               period: int | None = None, algo: str | None = None,
               fill_mode: str | None = None, data: Any = None) -> SyncPlan:
        """Re-solve the schedule for a changed link/membership/algorithm.

        A bandwidth drift or an elastic membership change only requires
        a cheap re-profile and a new partition search.  If training state
        exists, the worker axis is resharded (replicas averaged and
        re-broadcast — a synchronization point, so Lemma 4 survives) and
        the phase steps are rebuilt in place.

        A session built with a custom ``data=`` override must supply a
        replacement via ``data=`` here when ``workers`` changes.
        """
        updates: dict[str, Any] = {}
        for key, val in (("bandwidth", bandwidth), ("latency", latency),
                         ("workers", workers), ("period", period),
                         ("algo", algo), ("fill_mode", fill_mode)):
            if val is not None:
                updates[key] = val
        if self._runner is not None and self.use_async:
            raise ValueError(
                "replan() is not supported on a running async session: "
                "the op-log replay pins one timeline.  Express membership "
                "and bandwidth changes as scenario events instead "
                "(WorkerJoin/WorkerLeave/BandwidthDrift).")
        old_workers = self.cfg.workers
        old_strategy = self.strategy
        workers_changed = workers is not None and workers != old_workers
        # validate before mutating any session state, so a failed replan
        # leaves the session consistent
        new_strategy = get_strategy(algo) if algo is not None \
            else self.strategy
        if workers_changed and data is None and not self._owns_data and \
                self._data is not None:
            raise ValueError(
                "replan(workers=...) on a session with a custom data "
                "source: pass a replacement via replan(..., data=...) "
                "matching the new worker count")
        self.cfg = self.cfg.replace(**updates)
        self.strategy = new_strategy

        # cheap re-profile (paper §6): comm times re-derived for the link
        self._profile = self.profile().with_bandwidth(
            self.cfg.bandwidth, self.cfg.latency, self.cfg.workers)
        self._plan = self.strategy.build_plan(
            self._profile, self.cfg.period, fill_mode=self.cfg.fill_mode)

        if data is not None:
            self._data = data
            self._owns_data = False
            if self._runner is not None:
                self._runner.data = data

        if self._runner is not None:
            scfg = self.step_config
            if workers_changed:
                self._state = reshard_train_state(self._state,
                                                  self.cfg.workers)
                if self._owns_data:
                    self._data = self._make_data()
                    self._runner.data = self._data
            if algo is not None and type(self.strategy) is not \
                    type(old_strategy):
                # the sync policy may differ; re-derive its aux state
                ef, outer = scfg.policy.init_state(self._state.params)
                self._state = self._state._replace(ef=ef, outer=outer)
            self._runner.step_cfg = scfg
            self._runner.replan(self._plan)
        return self._plan

    # ------------------------------------------------------------- serving
    def serve(self, *, worker: int = 0,
              config: EngineConfig | None = None) -> ServeEngine:
        """The inference path: a continuous-batching :class:`ServeEngine`
        over one replica, on the session's device.

        The engine takes the arch's frontend (``"vision"``,
        ``"audio"``), so its requests bring their ``extra`` inputs.
        Engines are memoized per ``(frontend, config, worker)``: a repeated
        ``serve()`` after more ``fit()`` reuses the engine (its pool and
        captured decode graphs) and copies the replica's current values
        into its parameters.  The engine holds its own copy of them, so
        a later ``fit()`` (which updates the training state in place)
        does not reach it until ``serve()`` is called again.  An engine
        with requests queued or in flight is not reset: ``drain()`` it
        first.
        """
        cfg = config or EngineConfig()
        model = self.model                  # also resolves self._frontend
        key = (self._frontend, cfg, worker)
        if self._state is not None:
            params = worker_unstack(self._state.params, worker)
        elif self._params is not None:
            params = tree_map(lambda x: x.to(self.device), self._params)
        else:       # the initial parameters, the ones fit() starts from
            params = model.init(
                torch.Generator(self.device).manual_seed(self.cfg.seed))
        engine = self._engines.get(key)
        if engine is None:
            engine = ServeEngine(
                model, tree_map(lambda x: x.detach().clone(), params),
                cfg, device=self.device, frontend=self._frontend)
            self._engines[key] = engine
        else:
            if engine.has_work:
                raise RuntimeError(
                    "serve() would reset an engine with queued/in-flight "
                    "requests; drain() the previous handle first (or "
                    "serve() with a different EngineConfig)")
            engine.reset(params=params)
        return engine

    # ----------------------------------------------------------- simulation
    def simulate(self, scenario, *, periods: int | None = None,
                 replan: bool = True, n_channels: int = 1,
                 profile: LayerProfile | None = None,
                 mode: str | None = None):
        """Replay this job's schedule through a virtual geo-cluster.

        ``scenario`` is a :class:`repro_torch.sim.Scenario` or a library
        name (``"drifting-bandwidth"``, ``"churn"``, ...).  Pure
        analysis: no training state is built.  The strategy's plan is
        solved against the scenario's network at t=0 and replayed by
        :class:`repro_torch.sim.SimExecutor`; with ``replan=True`` (the
        default) every schedule-relevant event — bandwidth drift, link
        degradation, elastic join/leave — triggers a re-solve at the
        next period boundary, exactly like a live ``.replan()`` call.

        ``mode`` picks the execution model: ``"sync"`` replays the
        barriered period executor, ``"async"`` the two-tier
        :class:`repro_torch.hier.AsyncSimExecutor` (per-worker virtual
        clocks, staleness-aware merges; ``replan``/``n_channels`` don't
        apply).  Default follows the session: async when
        :attr:`use_async`.

        ``profile`` substitutes an external :class:`LayerProfile` for the
        model-derived one (e.g. a ``measured_profile`` of the card).

        Returns a :class:`repro_torch.sim.SimReport` (trace + plan
        history).
        """
        from ..sim import (REPLAN_EVENTS, SimExecutor, SimReport,
                           get_scenario, prepare_run)
        if isinstance(scenario, str):
            scenario = get_scenario(scenario)
        base = self.profile() if profile is None else profile
        if mode is None:
            mode = "async" if self.use_async else "sync"
        if mode not in ("sync", "async"):
            raise ValueError(f"mode must be 'sync' or 'async', got {mode!r}")
        cluster, plan = prepare_run(scenario, self.strategy,
                                    self.cfg.period, base,
                                    fill_mode=self.cfg.fill_mode)
        if mode == "async":
            from ..hier import AsyncSimExecutor
            ex = AsyncSimExecutor(base, plan, cluster,
                                  cfg=self.async_config)
            trace = ex.run(periods if periods is not None
                           else scenario.periods)
            return SimReport(scenario=scenario.name, trace=trace,
                             plans=[(0, plan)])
        ex = SimExecutor(base, plan, cluster, n_channels=n_channels)
        plans = [(0, plan)]

        def on_events(executor, fired):
            if not replan or not any(isinstance(e, REPLAN_EVENTS)
                                     for e in fired):
                return None
            eff = cluster.effective_profile(base, executor.clock)
            new_plan = self.strategy.build_plan(
                eff, executor.plan.H, fill_mode=self.cfg.fill_mode)
            if new_plan.fingerprint() == executor.plan.fingerprint():
                return None
            plans.append((executor.iteration // executor.plan.H,
                          new_plan))
            return new_plan

        trace = ex.run(periods if periods is not None else scenario.periods,
                       on_events=on_events)
        return SimReport(scenario=scenario.name, trace=trace, plans=plans)


class InferenceSession:
    """Deprecated shim over :class:`~repro_torch.serve.ServeEngine`.

    Keeps the old ``generate(tokens, max_new_tokens, *extra)`` call alive
    by delegating to an engine's array form (greedy, no EOS exit: the old
    loop's tokens).  New code should use ``Session.serve()``, which
    returns the engine.  The engine reads ``params`` in place.
    """

    def __init__(self, model, params, *, frontend: str | None = None,
                 config: EngineConfig | None = None,
                 device: str | torch.device | None = None):
        warnings.warn(
            "InferenceSession is deprecated: Session.serve() returns a "
            "repro_torch.serve.ServeEngine (continuous batching, EOS exit, "
            "sampling, stats) — use it directly",
            DeprecationWarning, stacklevel=2)
        self.model = model
        self.params = params
        self.device = resolve_device(device)
        self.frontend = frontend
        self._config = config
        self.engine: ServeEngine | None = None

    def generate(self, tokens, max_new_tokens: int = 16,
                 *extra) -> torch.Tensor:
        """Prefill ``tokens`` ``[B, S]`` (with the frontend's inputs
        ``extra``, each ``[B, ...]``) then decode greedily: ``[B,
        max_new_tokens]`` int32."""
        need = prefix_len(self.frontend, extra) + tokens.shape[1] + max(max_new_tokens, 0)
        # the old loop sized its cache per call; grow max_seq to match so
        # any request the old loop handled still works
        if self.engine is None or need > self.engine.config.max_seq:
            base = self._config or EngineConfig()
            max_seq = max(base.max_seq, need)
            if base.kv_backend == "paged":    # pages divide the lane
                max_seq += (-max_seq) % base.page_size
            self.engine = ServeEngine(
                self.model, self.params,
                dataclasses.replace(base, max_seq=max_seq),
                device=self.device, frontend=self.frontend)
        self.engine.reset(params=self.params)
        return self.engine.generate(tokens, max_new_tokens, *extra)
