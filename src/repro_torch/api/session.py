"""Declarative Session facade: one object from job spec to trained model.

Counterpart of ``repro.api.session`` in sync mode::

    from repro_torch.api import JobConfig, Session

    sess = Session(JobConfig(arch="granite-3-2b", algo="dreamddp",
                             workers=8, period=5, bandwidth=1e9))
    sess.fit(100)                      # profile -> plan -> train
    sess.replan(bandwidth=1e8)         # link drifted: re-solve + hot-swap
    sess.fit(100)                      # continue on the new schedule

Everything is lazy: ``.plan`` / ``.profile()`` work without ever building
training state, and ``.fit`` builds the runner on first call.  Training
runs on the GPU unless the session is made with ``device="cpu"``.

Not ported yet, and raising ``NotImplementedError`` naming the ROADMAP
item: the async two-tier runtime (``async_mode`` or an ``async_runtime``
strategy such as ``hier-async``; queue A item 10), :meth:`Session.simulate`
(SimNet, the same item), :meth:`Session.serve` (use
:class:`repro_torch.serve.ServeEngine` directly; queue A item 8) and
checkpoints (``ckpt_dir``; queue A item 6).
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Any

import torch

from ..core.plans import SyncPlan
from ..core.profiler import HardwareSpec, LayerProfile, analytic_profile
from ..data import MarkovCorpus
from ..device import resolve_device
from ..optim import make_optimizer
from ..runtime import (Runner, RunnerConfig, StepConfig, TrainState,
                       init_train_state)
from ..runtime.runner import reshard_train_state
from .registry import get_strategy

__all__ = ["JobConfig", "Session"]

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
    ``batch(step)``).  ``device`` is where training runs: the GPU by
    default (raising without one), the CPU only when asked for.
    """

    def __init__(self, cfg: JobConfig, *, model: Any = None,
                 data: Any = None, ckpt: Any = None,
                 device: str | torch.device | None = None):
        if ckpt is not None or cfg.ckpt_dir:
            raise NotImplementedError(
                "checkpoints are not ported to repro_torch yet (ROADMAP.md "
                "queue A item 6)")
        self.cfg = cfg
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
        return MarkovCorpus(vocab=self.model.cfg.vocab,
                            seq_len=self.cfg.seq,
                            batch_per_worker=self.cfg.batch_per_worker,
                            n_workers=self.cfg.workers, seed=self.cfg.seed,
                            device=self.device)

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
        gen = torch.Generator(self.device).manual_seed(cfg.seed)
        self._state = init_train_state(self.model, self._opt, gen,
                                       cfg.workers, cfg=scfg)
        self._runner = Runner(self.model, self._opt, self.plan, self._data,
                              step_cfg=scfg,
                              run_cfg=RunnerConfig(
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

    # --------------------------------------------------- not ported yet
    def simulate(self, *args, **kwargs):
        """SimNet replay of the schedule: not ported yet."""
        raise NotImplementedError(
            "Session.simulate (SimNet) is not ported to repro_torch yet "
            "(ROADMAP.md queue A item 10)")

    def serve(self, *args, **kwargs):
        """The reference's serving handle: not ported yet."""
        raise NotImplementedError(
            "Session.serve() is not ported to repro_torch yet (ROADMAP.md "
            "queue A item 8): build a repro_torch.serve.ServeEngine over "
            "repro_torch.core.partial_sync.worker_unstack(state.params)")
