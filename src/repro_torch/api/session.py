"""Declarative Session facade: one object from job spec to trained model.

Counterpart of ``repro.api.session`` in sync mode::

    from repro_torch.api import JobConfig, Session

    sess = Session(JobConfig(arch="granite-3-2b", algo="dreamddp",
                             workers=8, period=5, bandwidth=1e9))
    sess.fit(100)                      # profile -> plan -> train
    sess.replan(bandwidth=1e8)         # link drifted: re-solve + hot-swap
    sess.fit(100)                      # continue on the new schedule

    engine = sess.serve()              # a ServeEngine over worker 0
    engine.generate(tokens, 16)

Everything is lazy: ``.plan`` / ``.profile()`` work without ever building
training state, and ``.fit`` builds the runner on first call.  Training
and serving run on the GPU unless the session is made with
``device="cpu"``.  With ``ckpt_dir`` (or a ``ckpt=`` manager) the runner
saves every ``ckpt_every`` steps and restarts from the last checkpoint
after a failure; :meth:`Session.restore` resumes a session from one.

Not ported yet, and raising ``NotImplementedError`` naming the ROADMAP
item: the async two-tier runtime (``async_mode`` or an ``async_runtime``
strategy such as ``hier-async``; queue A item 10) and
:meth:`Session.simulate` (SimNet, the same item).
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
from ..serve import EngineConfig, ServeEngine
from ..tree import tree_map
from .registry import get_strategy

__all__ = ["JobConfig", "Session", "InferenceSession"]

_ASYNC_TODO = ("the async two-tier runtime is not ported to repro_torch "
               "yet (ROADMAP.md queue A item 10)")


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
    # asynchronous two-tier execution (not ported: ROADMAP.md A10)
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
    one over ``cfg.ckpt_dir``).  ``device`` is where training runs: the
    GPU by default (raising without one), the CPU only when asked for.
    """

    def __init__(self, cfg: JobConfig, *, model: Any = None,
                 data: Any = None, ckpt: CheckpointManager | None = None,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self._ckpt = ckpt
        self.device = resolve_device(device)
        self.strategy = get_strategy(cfg.algo)
        self._model = model
        self._data = data
        self._owns_data = data is None
        self._profile: LayerProfile | None = None
        self._plan: SyncPlan | None = None
        self._opt = None
        self._runner: Runner | None = None
        self._state: TrainState | None = None
        self._step = 0
        self._engines: dict[tuple[EngineConfig, int], ServeEngine] = {}

    # ------------------------------------------------------------ lazy parts
    @property
    def model(self):
        if self._model is None:
            from ..configs import get_arch
            arch = get_arch(self.cfg.arch)
            self._model = (arch.make_smoke() if self.cfg.smoke
                           else arch.make_model())
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

    @property
    def use_async(self) -> bool:
        """Whether training asks for the async two-tier runtime."""
        return bool(self.cfg.async_mode
                    or getattr(self.strategy, "async_runtime", False))

    @property
    def state(self) -> TrainState:
        self._ensure_built()
        return self._state

    @property
    def history(self) -> list[dict]:
        return self._runner.history if self._runner is not None else []

    @property
    def runner(self) -> Runner:
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
        if self.use_async:
            raise NotImplementedError(_ASYNC_TODO)
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
        gen = torch.Generator(self.device).manual_seed(cfg.seed)
        self._state = init_train_state(self.model, self._opt, gen,
                                       cfg.workers, cfg=scfg)
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
        """
        self._ensure_built()
        self._state = self._runner.run(self._state, steps,
                                       start_step=self._step)
        self._step += steps
        return self

    def restore(self, step: int | None = None) -> int:
        """Resume from a checkpoint of this session's manager (the latest
        by default): the state is loaded in place and ``fit`` continues
        from its step, which is returned."""
        self._ensure_built()
        if self._ckpt is None:
            raise ValueError("restore() needs a session made with ckpt_dir "
                             "or ckpt=")
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

        Engines are memoized per ``(config, worker)``: a repeated
        ``serve()`` after more ``fit()`` reuses the engine (its pool and
        captured decode graphs) and copies the replica's current values
        into its parameters.  The engine holds its own copy of them, so
        a later ``fit()`` (which updates the training state in place)
        does not reach it until ``serve()`` is called again.  An engine
        with requests queued or in flight is not reset: ``drain()`` it
        first.
        """
        cfg = config or EngineConfig()
        key = (cfg, worker)
        if self._state is not None:
            params = worker_unstack(self._state.params, worker)
        else:       # the initial parameters, the ones fit() starts from
            params = self.model.init(
                torch.Generator(self.device).manual_seed(self.cfg.seed))
        engine = self._engines.get(key)
        if engine is None:
            engine = ServeEngine(
                self.model, tree_map(lambda x: x.detach().clone(), params),
                cfg, device=self.device)
            self._engines[key] = engine
        else:
            if engine.has_work:
                raise RuntimeError(
                    "serve() would reset an engine with queued/in-flight "
                    "requests; drain() the previous handle first (or "
                    "serve() with a different EngineConfig)")
            engine.reset(params=params)
        return engine

    # --------------------------------------------------- not ported yet
    def simulate(self, *args, **kwargs):
        """SimNet replay of the schedule: not ported yet."""
        raise NotImplementedError(
            "Session.simulate (SimNet) is not ported to repro_torch yet "
            "(ROADMAP.md queue A item 10)")


class InferenceSession:
    """Deprecated shim over :class:`~repro_torch.serve.ServeEngine`.

    Keeps the old ``generate(tokens, max_new_tokens)`` call alive by
    delegating to an engine's array form (greedy, no EOS exit: the old
    loop's tokens).  New code should use ``Session.serve()``, which
    returns the engine.  The engine reads ``params`` in place.
    """

    def __init__(self, model, params, *, config: EngineConfig | None = None,
                 device: str | torch.device | None = None):
        warnings.warn(
            "InferenceSession is deprecated: Session.serve() returns a "
            "repro_torch.serve.ServeEngine (continuous batching, EOS exit, "
            "sampling, stats) — use it directly",
            DeprecationWarning, stacklevel=2)
        self.model = model
        self.params = params
        self.device = resolve_device(device)
        self._config = config
        self.engine: ServeEngine | None = None

    def generate(self, tokens, max_new_tokens: int = 16) -> torch.Tensor:
        """Prefill ``tokens`` ``[B, S]`` then decode greedily: ``[B,
        max_new_tokens]`` int32."""
        need = tokens.shape[1] + max(max_new_tokens, 0)
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
                device=self.device)
        self.engine.reset(params=self.params)
        return self.engine.generate(tokens, max_new_tokens)
