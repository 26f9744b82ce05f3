"""Training runner: per-step and period-fused execution, straggler requeue.

Counterpart of ``repro.runtime.runner`` (sync mode):

* **per-step path** — one step per iteration, a device synchronize and a
  host read of its metrics after each;
* **period fusion** (``RunnerConfig.fused_period``, ``period_exec=
  "pipeline"``) — the H phase steps of a period are queued back to back
  with no host round-trip between them and ONE ``torch.cuda.synchronize``
  at the period boundary; metrics stay on the device until the
  ``log_every`` drain, which reads every undrained period in one
  transfer; the next period's data is staged while the current one runs.
  The phase steps are the per-step path's own functions, so the two
  paths give identical states;
* **straggler mitigation** — a sync phase (per-step path) or period
  (fused path) whose wall-clock exceeds ``deadline_factor x`` the running
  median has its layer units re-queued into a make-up sync at the next
  period boundary (sound because partial sync tolerates per-layer
  staleness <= 2H, Lemma 4);
* **replan** — hot-swap the schedule mid-run; :func:`reshard_train_state`
  maps a state onto a new worker count.

Not ported yet, and raising ``NotImplementedError`` naming the ROADMAP
item: checkpoint save/restore and the restart-on-failure around it
(``repro.checkpoint``; queue A item 6), :meth:`Runner.restore_elastic`
(the same), and ``period_exec="compiled"`` (a CUDA graph per period;
queue A item 7).

The steps update the state in place, so :meth:`Runner.run` consumes the
state it is given (the reference's fused path donates it likewise).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from ..core.plans import SyncPlan, local_plan
from ..tree import tree_map
from .pipeline import PeriodPrefetcher
from .step import StepConfig, TrainState, compose_makeup_step, make_train_step

__all__ = ["RunnerConfig", "Runner", "reshard_train_state", "reshard_workers"]

Tree = Any

_CKPT_TODO = ("checkpoints are not ported to repro_torch yet (ROADMAP.md "
              "queue A item 6)")


def reshard_workers(tree: Tree, w_new: int) -> Tree:
    """Elastically change the worker-replica count: every leaf's axis 0
    is averaged (float32) and broadcast to ``w_new`` replicas — all
    workers restart from a synchronization point."""
    def one(x):
        m = x.float().mean(0, keepdim=True).to(x.dtype)
        return m.expand(w_new, *x.shape[1:]).contiguous()
    return tree_map(one, tree)


def reshard_train_state(state: TrainState, n_workers: int) -> TrainState:
    """Map a worker-stacked TrainState onto a new worker count (replicas
    averaged and re-broadcast: a synchronization point).  Used by
    ``Session.replan``."""
    opt = {k: (None if v is None else reshard_workers(v, n_workers))
           for k, v in state.opt_state.items()}
    outer = None if state.outer is None else type(state.outer)(
        *(reshard_workers(t, n_workers) for t in state.outer))
    return TrainState(
        params=reshard_workers(state.params, n_workers),
        opt_state=opt, step=state.step,
        ef=None if state.ef is None else reshard_workers(state.ef,
                                                         n_workers),
        outer=outer)


@dataclass(frozen=True)
class RunnerConfig:
    """The reference's fields, less the checkpoint ones (``ckpt_every``,
    ``max_retries``: checkpoints are not ported)."""

    deadline_factor: float = 3.0       # straggler: requeue if > 3x median
    min_history: int = 8               # steps/periods before deadlines fire
    log_every: int = 10                # fused: periods between metric drains
    fused_period: bool = False         # period-granularity execution
    # "pipeline": the H phase steps queued back to back, one device
    # synchronize per period.  "compiled" (one CUDA graph per period)
    # is not ported yet.
    period_exec: str = "pipeline"
    # depth-k data staging (pipeline.py)
    prefetch_depth: int = 1
    prefetch_background: bool = False


def _synchronize(state: TrainState) -> None:
    """Wait for the device work behind ``state`` (no-op on the CPU)."""
    if state.step.is_cuda:
        torch.cuda.synchronize(state.step.device)


@dataclass
class Runner:
    model: Any
    optimizer: Any
    plan: SyncPlan
    data: Any                           # .batch(step) -> dict of tensors
    ckpt: Any = None
    step_cfg: StepConfig = field(default_factory=StepConfig)
    run_cfg: RunnerConfig = field(default_factory=RunnerConfig)

    def __post_init__(self):
        if self.ckpt is not None:
            raise NotImplementedError(_CKPT_TODO)
        if self.run_cfg.period_exec not in ("pipeline", "compiled"):
            raise ValueError(f"period_exec must be 'pipeline' or "
                             f"'compiled', got {self.run_cfg.period_exec!r}")
        self._build_steps()
        self._times: list[float] = []
        self.period_times: list[float] = []
        self.history: list[dict] = []
        self.pending_units: set[int] = set()
        self.skipped_syncs = 0
        self._undrained: list[tuple[int, float, list[dict]]] = []
        self._prefetch: PeriodPrefetcher | None = None

    def _build_steps(self) -> None:
        """(Re)build the phase steps for the current plan."""
        self._steps = [make_train_step(self.model, self.optimizer,
                                       self.plan, h, cfg=self.step_cfg)
                       for h in range(self.plan.H)]
        # a pure local step (no sync) for straggler make-ups
        self._local = make_train_step(
            self.model, self.optimizer, local_plan(self.plan.n_units), 0,
            cfg=self.step_cfg)
        self._makeup_cache: dict[tuple, Callable] = {}

    def replan(self, new_plan: SyncPlan) -> None:
        """Hot-swap the schedule mid-run (elasticity / bandwidth drift).

        Pending straggler make-ups are kept — unit ids refer to the same
        network-order layout — but the phase steps are rebuilt so every
        subsequent step runs the new partition.
        """
        if new_plan.n_units != self.plan.n_units:
            raise ValueError(
                f"replan changed the unit count ({self.plan.n_units} -> "
                f"{new_plan.n_units}); the model layout must be stable")
        self.plan = new_plan
        self._build_steps()

    # ------------------------------------------------------------------ util
    def _median_time(self) -> float:
        xs = sorted(self._times[-64:])
        return xs[len(xs) // 2] if xs else float("inf")

    def _median_period_time(self) -> float:
        xs = sorted(self.period_times[-64:])
        return xs[len(xs) // 2] if xs else float("inf")

    def _makeup_step(self, units: tuple[int, ...]):
        if units not in self._makeup_cache:
            self._makeup_cache[units] = compose_makeup_step(
                self._local, units, self.model.unit_layout())
        return self._makeup_cache[units]

    def _drain_metrics(self) -> None:
        """Turn device-resident period metrics into history rows with ONE
        device-to-host transfer for every undrained period."""
        if not self._undrained:
            return
        keys = [(i, h, k) for i, (_, _, ms) in enumerate(self._undrained)
                for h, m in enumerate(ms) for k in m]
        vals = torch.stack([self._undrained[i][2][h][k].float()
                            for i, h, k in keys]).tolist()
        rows: dict[tuple[int, int], dict] = {}
        for (i, h, k), v in zip(keys, vals, strict=True):
            rows.setdefault((i, h), {})[k] = v
        for i, (r0, dt, ms) in enumerate(self._undrained):
            for h in range(len(ms)):
                self.history.append({
                    "step": r0 + h,
                    "phase": self.plan.phase_of_iteration(r0 + h),
                    "time": dt / len(ms), **rows[(i, h)]})
        self._undrained.clear()

    # ------------------------------------------------------------------- run
    def run(self, state: TrainState, n_steps: int, *,
            start_step: int = 0, fused: bool | None = None,
            inject_straggler_at: tuple[int, float] | None = None
            ) -> TrainState:
        """Train; ``inject_straggler_at = (step, seconds)`` adds a stall to
        one step's measured time, for the straggler tests (the
        reference's ``inject_failure_at`` needs checkpoints to restore
        from, which are not ported).

        ``fused=None`` follows ``RunnerConfig.fused_period`` — except
        when the hook is supplied, which drops to the per-step path (it
        addresses one iteration).  Pass ``fused=True`` to keep the fused
        path with the hook re-expressed at period granularity.
        """
        if fused is None:
            fused = self.run_cfg.fused_period and inject_straggler_at is None
        if not fused:
            return self._run_per_step(state, n_steps,
                                      start_step=start_step,
                                      inject_straggler_at=inject_straggler_at)
        return self._run_fused(state, n_steps, start_step=start_step,
                               inject_straggler_at=inject_straggler_at)

    # -------------------------------------------------------- per-step path
    def _run_per_step(self, state: TrainState, n_steps: int, *,
                      start_step: int = 0,
                      inject_straggler_at: tuple[int, float] | None = None
                      ) -> TrainState:
        for r in range(start_step, start_step + n_steps):
            phase = self.plan.phase_of_iteration(r)
            batch = self.data.batch(r)
            t0 = time.perf_counter()
            if self.pending_units and phase == 0:
                fn = self._makeup_step(tuple(sorted(self.pending_units)))
                self.pending_units.clear()
            else:
                fn = self._steps[phase]
            state, metrics = fn(state, batch)
            # wait for the COMPLETED step, parameter syncs included,
            # before stamping the deadline clock
            _synchronize(state)

            dt = time.perf_counter() - t0
            if inject_straggler_at is not None and inject_straggler_at[0] == r:
                dt += inject_straggler_at[1]
                inject_straggler_at = None
            # straggler policy: a sync phase that blew the deadline has its
            # units requeued into a make-up sync at the next period start
            if (len(self._times) >= self.run_cfg.min_history
                    and self.plan.is_parameter_sync
                    and self.plan.units_for_phase(phase)
                    and dt > self.run_cfg.deadline_factor
                    * self._median_time()):
                self.pending_units.update(self.plan.units_for_phase(phase))
                self.skipped_syncs += 1
            self._times.append(dt)
            vals = torch.stack([v.float() for v in metrics.values()]).tolist()
            self.history.append({"step": r, "phase": phase, "time": dt,
                                 **dict(zip(metrics, vals, strict=True))})
        return state

    # ----------------------------------------------------------- fused path
    def _run_fused(self, state: TrainState, n_steps: int, *,
                   start_step: int = 0,
                   inject_straggler_at: tuple[int, float] | None = None
                   ) -> TrainState:
        """Whole synchronization periods with one device synchronize each.

        Iterations that don't fill a whole period — a mis-aligned start
        (replan landing mid-period) or the run's tail — run on the
        per-step path, so any ``start_step`` / ``n_steps`` combination is
        exact.
        """
        if self.run_cfg.period_exec == "compiled":
            raise NotImplementedError(
                "period_exec='compiled' (one CUDA graph per period) is not "
                "ported to repro_torch yet (ROADMAP.md queue A item 7); "
                "use 'pipeline'")
        H = self.plan.H
        r, end = start_step, start_step + n_steps
        cfg = self.run_cfg
        if self._prefetch is None or self._prefetch.data is not self.data \
                or self._prefetch.h != H \
                or self._prefetch.depth != max(1, cfg.prefetch_depth) \
                or self._prefetch.background != cfg.prefetch_background:
            self._prefetch = PeriodPrefetcher(
                self.data, H, stacked=False, depth=cfg.prefetch_depth,
                background=cfg.prefetch_background)
        pipe = self._prefetch

        def in_period(step):
            return step is not None and r <= step < r + H

        while r < end:
            if r % H != 0 or r + H > end:
                # partial period: per-step path up to the next period
                # boundary (or the end of the run).  Drain first so
                # history rows stay in step order.
                self._drain_metrics()
                n = min(end - r, H - r % H if r % H else end - r)
                strag = None
                if inject_straggler_at is not None and \
                        r <= inject_straggler_at[0] < r + n:
                    strag, inject_straggler_at = inject_straggler_at, None
                state = self._run_per_step(state, n, start_step=r,
                                           inject_straggler_at=strag)
                r += n
                continue

            batch = pipe.get(r)
            t0 = time.perf_counter()
            makeup = ()
            if self.pending_units:
                makeup = tuple(sorted(self.pending_units))
                self.pending_units.clear()
            # the H phase steps queued back to back: no host round-trip
            # between phases, one synchronize at the period boundary
            metrics = []
            for h in range(H):
                fn = self._makeup_step(makeup) if h == 0 and makeup \
                    else self._steps[h]
                state, m = fn(state, batch[h])
                metrics.append(m)
            if r + 2 * H <= end:
                # stage p+1..p+depth under p's device work; never past
                # the last full period of this run
                pipe.prefetch(r + H, last=end - H)
            _synchronize(state)

            dt = time.perf_counter() - t0
            if inject_straggler_at is not None and \
                    in_period(inject_straggler_at[0]):
                dt += inject_straggler_at[1]
                inject_straggler_at = None
            # straggler deadline at period granularity: a blown period
            # can't be attributed to one phase, so every unit the period
            # syncs is re-queued for make-up (a superset of the per-step
            # requeue — extra syncs only tighten Lemma 4's bound)
            if (len(self.period_times) >= self.run_cfg.min_history
                    and self.plan.is_parameter_sync
                    and dt > self.run_cfg.deadline_factor
                    * self._median_period_time()):
                self.pending_units.update(self.plan.all_sync_units())
                self.skipped_syncs += 1
            self.period_times.append(dt)

            self._undrained.append((r, dt, metrics))
            if len(self._undrained) >= self.run_cfg.log_every:
                self._drain_metrics()
            r += H
        self._drain_metrics()
        return state

    def restore_elastic(self, template: TrainState, n_workers: int,
                        new_plan: SyncPlan) -> tuple[int, TrainState]:
        """Restore onto a different worker count: needs checkpoints."""
        raise NotImplementedError(_CKPT_TODO)
