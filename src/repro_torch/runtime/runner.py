"""Fault-tolerant training runner: per-step and period-fused execution,
checkpoint/restart, straggler requeue, elastic restore.

Counterpart of ``repro.runtime.runner`` (sync mode):

* **per-step path** — one step per iteration, a device synchronize and a
  host read of its metrics after each;
* **period fusion** (``RunnerConfig.fused_period``) — whole H-step
  periods with ONE ``torch.cuda.synchronize`` at each period boundary;
  metrics stay on the device until the ``log_every`` drain, which reads
  every undrained period in one transfer; the next period's data is
  staged while the current one runs.  Two executors
  (``RunnerConfig.period_exec``):

  - ``"pipeline"`` — the H phase steps queued back to back;
  - ``"compiled"`` — the period as one CUDA graph
    (:func:`~repro_torch.runtime.step.make_period_step`, the same phase
    bodies).  The first full period with a given straggler make-up key
    runs eagerly on the capture stream (a real training period that also
    warms up kernel builds, cuBLAS handles and lazy allocations); that
    key's period is then captured once, outside any period's time, and
    every later period is a copy of its staged batch into the graph's
    static buffers, one replay and one synchronize.  Graphs are keyed by
    the make-up tuple, as the reference keys its period programs, and
    share one memory pool: replays are serial and every output is
    copied out or lives in the state.  A graph holds the addresses of
    the state it captured, so a state with other tensors, a ``replan``
    or an elastic restore drops every graph and the next full period
    captures again; a restart restores in place and keeps them.  A
    capture that fails raises.  On the CPU the same period body runs
    without a graph.

  Both give the per-step path's states bitwise: the same bodies run the
  same kernels in the same order.  Each full period records a device
  boundary at its start and after each phase's gradients, optimizer and
  sync (:class:`~repro_torch.spans.PhaseMarks`; a captured period
  records them on every replay); they are read after the period's one
  synchronize, and every history row of a full period carries its
  phase's ``grads_s``, ``optimizer_s`` and ``sync_s``;
* **checkpoint/restart** — periodic async checkpoints
  (``RunnerConfig.ckpt_every``, ``meta={"plan": ...}``); an exception
  inside a step or period restores the last checkpoint **in place** and
  replays (at most ``max_retries`` times);
* **straggler mitigation** — a sync phase (per-step path) or period
  (fused path) whose wall-clock exceeds ``deadline_factor x`` the running
  median has its layer units re-queued into a make-up sync at the next
  period boundary (sound because partial sync tolerates per-layer
  staleness <= 2H, Lemma 4);
* **replan / elasticity** — hot-swap the schedule mid-run;
  :meth:`Runner.restore_elastic` maps a checkpoint onto a new worker
  count (:func:`reshard_train_state`).

The steps update the state in place, so :meth:`Runner.run` consumes the
state it is given (the reference's fused path donates it likewise).
Batches from ``data`` go to the state's device (a data source on the
host is the usual case; the compiled mode stages it through pinned
memory).
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from ..checkpoint import CheckpointManager, reshard_workers
from ..core.plans import SyncPlan, local_plan
from ..kernels.fused_adam_sync import clip_scale, fused_adamw
from ..kernels.grouped_gemm import grouped_gemm
from ..kernels.int8_quant import dequantize_rows, quantize_rows
from ..lint import consumes, hot_path
from ..spans import PhaseMarks, span
from ..tree import tree_leaves
from .pipeline import PeriodPrefetcher, to_device
from .step import (StepConfig, TrainState, compose_makeup_step,
                   make_period_step, make_train_step)

__all__ = ["RunnerConfig", "Runner", "PeriodGraphStats",
           "reshard_train_state", "reshard_workers"]

Tree = Any

# the kernel wrappers whose launch counters say what a captured period holds
_KERNELS = (fused_adamw, clip_scale, quantize_rows, dequantize_rows,
            grouped_gemm)


def reshard_train_state(state: TrainState, n_workers: int) -> TrainState:
    """Map a worker-stacked TrainState onto a new worker count (replicas
    averaged and re-broadcast: a synchronization point).  Used by
    :meth:`Runner.restore_elastic` and ``Session.replan``."""
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


def _state_leaves(state: TrainState) -> list[torch.Tensor]:
    return [x for x in tree_leaves(state._asdict()) if x is not None]


@dataclass(frozen=True)
class RunnerConfig:
    ckpt_every: int = 200
    max_retries: int = 3
    deadline_factor: float = 3.0       # straggler: requeue if > 3x median
    min_history: int = 8               # steps/periods before deadlines fire
    log_every: int = 10                # fused: periods between metric drains
    fused_period: bool = False         # period-granularity execution
    # "pipeline": the H phase steps queued back to back; "compiled": the
    # period as one CUDA graph (the same bodies; on the CPU, no graph)
    period_exec: str = "pipeline"
    # depth-k data staging (pipeline.py)
    prefetch_depth: int = 1
    prefetch_background: bool = False


@dataclass
class PeriodGraphStats:
    """The compiled mode's record on CUDA.

    ``graphs``: periods captured (one per make-up key, again after a
    drop); ``capture_s``: seconds spent capturing them, outside every
    period's time; ``pool_bytes``: device bytes the captures reserved for
    the graphs' shared memory pool; ``captured_launches``: per make-up
    key, the kernel launches its graph holds by wrapper name (norm passes
    for ``clip_scale``; the wrappers' counters move during a capture,
    never on a replay), and
    ``captured_by_shape`` the same for ``quantize_rows`` by ``(rows,
    cols)``; ``replays``: graph replays per make-up key.
    """

    graphs: int = 0
    capture_s: float = 0.0
    pool_bytes: int = 0
    captured_launches: dict[tuple, dict[str, int]] = field(
        default_factory=dict)
    captured_by_shape: dict[tuple, collections.Counter] = field(
        default_factory=dict)
    replays: collections.Counter = field(
        default_factory=collections.Counter)

    def kernel_launches(self) -> dict[str, int]:
        """Kernel launches the periods made through graph replays, by
        wrapper name: replays x the launches each graph holds."""
        out: collections.Counter = collections.Counter()
        for key, n in self.replays.items():
            for name, k in self.captured_launches.get(key, {}).items():
                out[name] += n * k
        return dict(out)


@dataclass
class _PeriodGraph:
    graph: torch.cuda.CUDAGraph
    metrics: dict[str, torch.Tensor]   # [H] outputs in the graph's pool


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
    ckpt: CheckpointManager | None = None
    step_cfg: StepConfig = field(default_factory=StepConfig)
    run_cfg: RunnerConfig = field(default_factory=RunnerConfig)

    def __post_init__(self):
        if self.run_cfg.period_exec not in ("pipeline", "compiled"):
            raise ValueError(f"period_exec must be 'pipeline' or "
                             f"'compiled', got {self.run_cfg.period_exec!r}")
        self.graph_stats = PeriodGraphStats()
        self._graphs: dict[tuple, _PeriodGraph] = {}
        self._build_steps()
        self._times: list[float] = []
        self.period_times: list[float] = []
        self.history: list[dict] = []
        self.pending_units: set[int] = set()
        self.skipped_syncs = 0
        self.retries = 0
        # (first step, host seconds, device metrics, seconds by part a
        # phase) of each period not yet drained
        self._undrained: list[tuple[int, float, Any, list[dict]]] = []
        self._prefetch: PeriodPrefetcher | None = None
        self._graph_stream: torch.cuda.Stream | None = None
        self._graph_pool = None

    def _build_steps(self) -> None:
        """(Re)build the phase steps and period bodies for the current
        plan; captured periods are dropped."""
        self._steps = [make_train_step(self.model, self.optimizer,
                                       self.plan, h, cfg=self.step_cfg)
                       for h in range(self.plan.H)]
        # a pure local step (no sync) for straggler make-ups
        self._local = make_train_step(
            self.model, self.optimizer, local_plan(self.plan.n_units), 0,
            cfg=self.step_cfg)
        self._makeup_cache: dict[tuple, Callable] = {}
        self._period_cache: dict[tuple, Callable] = {}
        # one record of phase marks a make-up key, for either mode
        self._marks: dict[tuple, PhaseMarks] = {}
        self._drop_graphs()

    def _drop_graphs(self) -> None:
        """Forget every captured period, the state and batch buffers they
        read and which keys have warmed up."""
        self._graphs.clear()
        self._warm: set[tuple] = set()
        self._graph_leaves: list[torch.Tensor] | None = None
        self._static_batch: dict[str, torch.Tensor] | None = None

    def replan(self, new_plan: SyncPlan) -> None:
        """Hot-swap the schedule mid-run (elasticity / bandwidth drift).

        Pending straggler make-ups are kept — unit ids refer to the same
        network-order layout — but the phase steps are rebuilt (and any
        captured period dropped) so every subsequent step runs the new
        partition.
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

    def _period_step(self, makeup: tuple[int, ...]):
        if makeup not in self._period_cache:
            self._period_cache[makeup] = make_period_step(
                self.model, self.optimizer, self.plan, cfg=self.step_cfg,
                makeup_units=makeup, marks=self._phase_marks(makeup))
        return self._period_cache[makeup]

    def _phase_marks(self, makeup: tuple[int, ...]) -> PhaseMarks:
        """The phase marks of a full period with make-up ``makeup``."""
        if makeup not in self._marks:
            self._marks[makeup] = PhaseMarks(self.plan.H)
        return self._marks[makeup]

    def _can_restore(self) -> bool:
        """Only swallow a failure if a checkpoint exists to restart from
        — otherwise a restore FileNotFoundError would mask the real
        error.  latest_step() itself may raise (it surfaces a failed
        async save); never let that replace the training exception."""
        if self.ckpt is None or self.retries >= self.run_cfg.max_retries:
            return False
        try:
            return self.ckpt.latest_step() is not None
        except Exception:                             # noqa: BLE001
            return False

    def _restore_into(self, state: TrainState) -> int:
        """Restore the latest checkpoint into ``state``'s own tensors
        (a captured period keeps reading them); returns its step."""
        step, _, _ = self.ckpt.restore(state, in_place=True)
        return step

    @hot_path
    def _drain_metrics(self) -> None:
        """Turn device-resident period metrics into history rows with ONE
        device-to-host transfer for every undrained period.  A period's
        metrics are H per-phase dicts (pipeline) or one dict of ``[H]``
        tensors (compiled); its phases' seconds by part are on the host
        already."""
        if not self._undrained:
            return
        with span("repro_torch.train.drain"):
            vals = []
            for _, _, ms, _ in self._undrained:
                if isinstance(ms, dict):
                    vals += [v.float() for v in ms.values()]
                else:
                    vals += [v.float().reshape(1) for m in ms
                             for v in m.values()]
            flat = iter(torch.cat(vals).cpu().tolist())
            for r0, dt, ms, parts in self._undrained:
                if isinstance(ms, dict):
                    cols = {k: [next(flat) for _ in range(len(v))]
                            for k, v in ms.items()}
                    rows = [{k: c[h] for k, c in cols.items()}
                            for h in range(len(next(iter(cols.values()))))]
                else:
                    rows = [{k: next(flat) for k in m} for m in ms]
                for h, row in enumerate(rows):
                    self.history.append({
                        "step": r0 + h,
                        "phase": self.plan.phase_of_iteration(r0 + h),
                        "time": dt / len(rows), **row, **parts[h]})
            self._undrained.clear()

    # ------------------------------------------------------------------- run
    @consumes("state")
    def run(self, state: TrainState, n_steps: int, *,
            start_step: int = 0, fused: bool | None = None,
            inject_failure_at: int | None = None,
            inject_straggler_at: tuple[int, float] | None = None
            ) -> TrainState:
        """Train; ``inject_*`` hooks are for fault-tolerance tests
        (``inject_failure_at``: an exception at that step, restored from
        the last checkpoint; ``inject_straggler_at = (step, seconds)``: a
        stall added to that step's measured time).

        ``fused=None`` follows ``RunnerConfig.fused_period`` — except
        when an injection hook is supplied, which drops to the per-step
        path (hooks address individual iterations).  Pass ``fused=True``
        to keep the fused path with hooks re-expressed at period
        granularity (a failure or stall lands on the period containing
        the named step).
        """
        if fused is None:
            fused = (self.run_cfg.fused_period
                     and inject_failure_at is None
                     and inject_straggler_at is None)
        if not fused:
            return self._run_per_step(state, n_steps,
                                      start_step=start_step,
                                      inject_failure_at=inject_failure_at,
                                      inject_straggler_at=inject_straggler_at)
        return self._run_fused(state, n_steps, start_step=start_step,
                               inject_failure_at=inject_failure_at,
                               inject_straggler_at=inject_straggler_at)

    # -------------------------------------------------------- per-step path
    @hot_path
    @consumes("state")
    def _run_per_step(self, state: TrainState, n_steps: int, *,
                      start_step: int = 0,
                      inject_failure_at: int | None = None,
                      inject_straggler_at: tuple[int, float] | None = None
                      ) -> TrainState:
        r = start_step
        while r < start_step + n_steps:
            phase = self.plan.phase_of_iteration(r)
            batch = to_device(self.data.batch(r), state.step.device)
            t0 = time.perf_counter()
            try:
                if inject_failure_at == r:
                    inject_failure_at = None
                    raise RuntimeError("injected node failure")
                if self.pending_units and phase == 0:
                    fn = self._makeup_step(tuple(sorted(self.pending_units)))
                    self.pending_units.clear()
                else:
                    fn = self._steps[phase]
                state, metrics = fn(state, batch)
                # wait for the COMPLETED step, parameter syncs included,
                # before stamping the deadline clock
                _synchronize(state)
            except Exception:                         # noqa: BLE001
                if not self._can_restore():
                    raise
                self.retries += 1
                r = self._restore_into(state)
                continue

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
            # the synchronize above already waited; one explicit read
            vals = torch.stack([v.float() for v in metrics.values()])
            vals = vals.cpu().tolist()
            self.history.append({"step": r, "phase": phase, "time": dt,
                                 **dict(zip(metrics, vals, strict=True))})
            if self.ckpt is not None and \
                    (r + 1) % self.run_cfg.ckpt_every == 0:
                self.ckpt.save(r + 1, state,
                               meta={"plan": self.plan.to_json()})
            r += 1
        if self.ckpt is not None:
            self.ckpt.wait()
        return state

    # ----------------------------------------------------------- fused path
    @hot_path
    @consumes("state")
    def _run_fused(self, state: TrainState, n_steps: int, *,
                   start_step: int = 0,
                   inject_failure_at: int | None = None,
                   inject_straggler_at: tuple[int, float] | None = None
                   ) -> TrainState:
        """Whole synchronization periods with one device synchronize each.

        Iterations that don't fill a whole period — a mis-aligned start
        (elastic restore / replan landing mid-period) or the run's tail
        — run on the per-step path, so any ``start_step`` / ``n_steps``
        combination is exact.
        """
        H = self.plan.H
        r, end = start_step, start_step + n_steps
        cfg = self.run_cfg
        compiled = cfg.period_exec == "compiled"
        dev = state.step.device
        if self._prefetch is None or self._prefetch.data is not self.data \
                or self._prefetch.h != H \
                or self._prefetch.stacked != compiled \
                or self._prefetch.device != dev \
                or self._prefetch.depth != max(1, cfg.prefetch_depth) \
                or self._prefetch.background != cfg.prefetch_background:
            self._prefetch = PeriodPrefetcher(
                self.data, H, stacked=compiled, depth=cfg.prefetch_depth,
                background=cfg.prefetch_background, device=dev)
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
                fail = strag = None
                if inject_failure_at is not None and \
                        r <= inject_failure_at < r + n:
                    fail, inject_failure_at = inject_failure_at, None
                if inject_straggler_at is not None and \
                        r <= inject_straggler_at[0] < r + n:
                    strag, inject_straggler_at = inject_straggler_at, None
                state = self._run_per_step(state, n, start_step=r,
                                           inject_failure_at=fail,
                                           inject_straggler_at=strag)
                r += n
                continue

            batch = pipe.get(r)
            makeup = tuple(sorted(self.pending_units))
            if compiled and dev.type == "cuda":
                with span("repro_torch.train.capture"):
                    self._prepare_graph(makeup, state, batch)
            t0 = time.perf_counter()
            try:
                with span("repro_torch.train.period"):
                    if in_period(inject_failure_at):
                        inject_failure_at = None
                        raise RuntimeError("injected node failure")
                    self.pending_units.clear()
                    marks = self._phase_marks(makeup)
                    if compiled:
                        metrics = self._compiled_period(makeup, state, batch)
                    else:
                        # the H phase steps queued back to back: no host
                        # round-trip between phases
                        marks.start(dev)
                        metrics = []
                        for h in range(H):
                            fn = self._makeup_step(makeup) \
                                if h == 0 and makeup else self._steps[h]
                            state, m = fn(state, batch[h], marks.phase(h))
                            metrics.append(m)
                    if r + 2 * H <= end:
                        # stage p+1..p+depth under p's device work; never
                        # past the last full period of this run
                        with span("repro_torch.train.prefetch"):
                            pipe.prefetch(r + H, last=end - H)
                    # one synchronize at the period boundary times the
                    # COMPLETED period, parameter syncs included
                    _synchronize(state)
            except Exception:                         # noqa: BLE001
                if not self._can_restore():
                    raise
                self.retries += 1
                self._drain_metrics()
                pipe.invalidate()
                r = self._restore_into(state)
                continue

            dt = time.perf_counter() - t0
            parts = marks.read()
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

            self._undrained.append((r, dt, metrics, parts))
            if len(self._undrained) >= self.run_cfg.log_every:
                self._drain_metrics()
            if self.ckpt is not None and \
                    (r + H) // cfg.ckpt_every > r // cfg.ckpt_every:
                with span("repro_torch.train.checkpoint"):
                    self.ckpt.save(r + H, state,
                                   meta={"plan": self.plan.to_json()})
            r += H
        self._drain_metrics()
        if self.ckpt is not None:
            self.ckpt.wait()
        return state

    # ------------------------------------------------------ compiled mode
    def _compiled_period(self, makeup: tuple[int, ...], state: TrainState,
                         batch: dict) -> dict:
        """One full period -> its ``[H]`` metrics: the period body itself
        on the CPU; on CUDA the batch copied into the static buffers,
        then the key's first period eagerly on the capture stream, every
        later one as a replay."""
        body = self._period_step(makeup)
        if not state.step.is_cuda:
            return body(state, batch)[1]
        for k, v in batch.items():
            self._static_batch[k].copy_(v)
        g = self._graphs.get(makeup)
        if g is not None:
            g.graph.replay()
            self.graph_stats.replays[makeup] += 1
            # the next replay overwrites the graph's outputs
            return {k: v.clone() for k, v in g.metrics.items()}
        main = torch.cuda.current_stream(state.step.device)
        self._graph_stream.wait_stream(main)
        with torch.cuda.stream(self._graph_stream):
            _, metrics = body(state, self._static_batch)
        main.wait_stream(self._graph_stream)
        self._warm.add(makeup)
        return metrics

    def _prepare_graph(self, makeup: tuple[int, ...], state: TrainState,
                       batch: dict) -> None:
        """Before a full period on CUDA, outside its time: drop the graphs
        if they read another state's tensors or another batch layout;
        capture the key's period if its eager period has run."""
        leaves = _state_leaves(state)
        layout = {k: (v.shape, v.dtype) for k, v in batch.items()}
        if self._graph_leaves is None or len(leaves) != len(
                self._graph_leaves) or any(
                a is not b for a, b in zip(leaves, self._graph_leaves)) \
                or layout != {k: (v.shape, v.dtype) for k, v in
                              self._static_batch.items()}:
            self._drop_graphs()
            self._graph_leaves = leaves
            self._static_batch = {k: torch.empty_like(v)
                                  for k, v in batch.items()}
        if self._graph_stream is None:
            dev = state.step.device
            self._graph_stream = torch.cuda.Stream(dev)
            self._graph_pool = torch.cuda.graph_pool_handle()
        if makeup in self._warm and makeup not in self._graphs:
            self._capture(makeup, state)

    def _capture(self, makeup: tuple[int, ...], state: TrainState) -> None:
        """Capture the key's period body as a CUDA graph over the state
        and the static batch; raises if the capture fails."""
        dev = state.step.device
        if self.ckpt is not None:
            self.ckpt.wait()          # no writer thread calls CUDA mid-capture
        self._prefetch.settle()       # nor a staging thread
        body = self._period_step(makeup)
        before = [fn.launches for fn in _KERNELS]
        shapes = quantize_rows.launches_by_shape.copy()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        main = torch.cuda.current_stream(dev)
        self._graph_stream.wait_stream(main)
        try:
            with torch.cuda.graph(graph, pool=self._graph_pool,
                                  stream=self._graph_stream):
                reserved = torch.cuda.memory_reserved(dev)
                out, metrics = body(state, self._static_batch)
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing the period (make-up units {makeup}) as a CUDA "
                f"graph failed (a host read or an operation the capture "
                f"does not allow?): {e}") from e
        main.wait_stream(self._graph_stream)
        if any(a is not b for a, b in zip(_state_leaves(out),
                                          self._graph_leaves, strict=True)):
            raise RuntimeError("the period body rebound a state tensor; a "
                               "captured period must update it in place")
        stats = self.graph_stats
        stats.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        stats.captured_launches[makeup] = {
            fn.__name__: fn.launches - n
            for fn, n in zip(_KERNELS, before, strict=True)
            if fn.launches != n}
        stats.captured_by_shape[makeup] = \
            quantize_rows.launches_by_shape - shapes
        stats.capture_s += time.perf_counter() - t0
        stats.graphs += 1
        self._graphs[makeup] = _PeriodGraph(graph, metrics)

    # ------------------------------------------------------------ elastic
    def restore_elastic(self, template: TrainState, n_workers: int,
                        new_plan: SyncPlan) -> tuple[int, TrainState]:
        """Restore onto a different worker count (elastic membership):
        the latest checkpoint, resharded to ``n_workers`` on the
        template's device, and the phase steps rebuilt for
        ``new_plan``."""
        _, state, _ = self.ckpt.restore(template)
        state = reshard_train_state(state, n_workers)
        self.replan(new_plan)
        return int(state.step), state
