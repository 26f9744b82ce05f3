"""AsyncHierRunner — real training driven by the deterministic op log.

Counterpart of ``repro.hier.runner``.  The
:class:`~repro_torch.hier.executor.AsyncSimExecutor` decides *when*
things happen (on seeded virtual clocks); this runner executes *what*
happens, in exactly that order:

* ``PullOp``    — worker downloads the global float32 model (cast into
  its own parameter dtype) and keeps a float32 copy as its delta base;
* ``PeriodOp``  — worker runs one H-step local period (the period body
  of :func:`~repro_torch.runtime.step.make_period_step` over
  :func:`~repro_torch.core.plans.local_period_plan`, built once for a
  ``[H, 1, ...]`` single-worker batch and shared by every worker) and
  turns its base into its delta;
* ``PushOp``    — the per-phase layer-group delta lands at its
  datacenter's :class:`~repro_torch.hier.servers.LocalServer`;
* ``MergeOp``   — that server's accumulated batch merges into the
  :class:`~repro_torch.hier.servers.GlobalServer` with staleness-aware
  weight;
* ``JoinOp`` / ``LeaveOp`` — elastic membership: joiners bootstrap from
  the current global model with fresh optimizer state, leavers drop
  their local state (their already-pushed deltas still merge).

Every quantity that orders or scales an update (versions, staleness,
contributor sets) is carried *in* the op, and the runner asserts its own
server state agrees op-by-op — so the executor's timing machine and the
training math can never silently drift apart.  Checkpoints land only at
merge boundaries and store the full reachable state (worker states,
server tensors, in-flight deltas, membership, op cursor); a restore
regenerates the op log from the same seed and fast-forwards to the
cursor, which is why a resumed run replays to an identical trace and
bitwise-identical parameters.

Differences from the reference:

* the server merges in place (``servers.py``), so a pull **clones** the
  global model as the worker's float32 base (the reference may hold the
  server's own tree, which its merges never mutate).  The delta is then
  computed into that clone, ``p[0] - base`` in float32, so a worker's
  base and its delta are one buffer;
* the period runs **eagerly** through the pipeline body.  A CUDA graph
  of it (the sync runner's ``compiled`` mode) would pin the addresses of
  the one worker state it captured, and here every worker has its own;
  one graph per worker, or states swapped through static buffers, is
  left for later;
* the template state is made from ``seed`` with a ``torch.Generator``
  on ``device``, or from ``params`` (an unstacked tree, e.g. the JAX
  package's parameters through ``repro_torch.convert.params_from_numpy``);
  each worker's state and the global server are built from it.  A
  worker's fresh state is the global model cast into the template's
  dtypes with new optimizer state, so the template itself is not kept;
* the hot path carries the reference's ``@hot_path`` markers
  (``_run_ops``, ``_apply_op``, ``_period_batch``, ``_drain_metrics``;
  ``GlobalServer.merge``), which ``python -m repro_torch.lint`` polices:
  the one host read is the drain's explicit ``.cpu()``.

Times in the history are *virtual* (simulated seconds) — the runner
never reads a wall clock.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from ..core.partial_sync import worker_stack
from ..core.plans import SyncPlan, local_period_plan
from ..core.sync_policies import resolve_policy
from ..device import resolve_device
from ..lint import hot_path
from ..runtime.pipeline import to_device
from ..runtime.step import StepConfig, TrainState, make_period_step
from ..sim.executor import prepare_run
from ..tree import tree_map
from .executor import (AsyncConfig, AsyncSimExecutor, JoinOp, LeaveOp,
                       MergeOp, PeriodOp, PullOp, PushOp)
from .servers import GlobalServer, LocalServer

__all__ = ["AsyncHierRunner", "AsyncRunnerConfig"]

Tree = Any


@dataclass(frozen=True)
class AsyncRunnerConfig:
    async_cfg: AsyncConfig = field(default_factory=AsyncConfig)
    ckpt_every_merges: int = 0        # 0 = no periodic checkpoints
    fill_mode: str = "exact"


class AsyncHierRunner:
    """Execute async hierarchical training over a scenario's timeline."""

    def __init__(self, model, optimizer, strategy, data, *, profile,
                 scenario, step_cfg: StepConfig = StepConfig(),
                 run_cfg: AsyncRunnerConfig = AsyncRunnerConfig(),
                 H: int = 4, ckpt=None, seed: int = 0,
                 params: Tree | None = None,
                 device: str | torch.device | None = None):
        policy = resolve_policy(step_cfg)
        if policy.name != "mean":
            raise ValueError(
                f"async runtime requires the plain mean sync policy "
                f"(deltas are merged server-side); got {policy.name!r}")
        self.model = model
        self.optimizer = optimizer
        self.strategy = strategy
        self.data = data
        self.profile = profile
        self.scenario = scenario
        self.step_cfg = step_cfg
        self.run_cfg = run_cfg
        self.ckpt = ckpt
        self.seed = seed
        self.device = resolve_device(device)
        self.layout = model.unit_layout()
        self._policy = policy

        cluster, plan = prepare_run(scenario, strategy, H, profile,
                                    fill_mode=run_cfg.fill_mode)
        self.plan: SyncPlan = plan
        self.H = plan.H
        self._n_workers0 = cluster.n_active
        self._local_plan = local_period_plan(plan.n_units, plan.H)
        self._period_fn = make_period_step(model, optimizer,
                                           self._local_plan, cfg=step_cfg)
        if params is None:
            params = model.init(
                torch.Generator(self.device).manual_seed(seed))
        params = tree_map(lambda x: x.detach().to(self.device), params)
        self._dtypes = tree_map(lambda x: x.dtype, params)
        self.server = GlobalServer(params, self.layout,
                                   run_cfg.async_cfg.merge,
                                   n_workers=self._n_workers0)
        del params
        self.states: dict[int, TrainState] = {
            w: self._fresh_state() for w in sorted(cluster.active)}
        self.locals: dict[int, LocalServer] = {}
        self._bases: dict[int, Tree] = {}
        self._deltas: dict[tuple[int, int], Tree] = {}
        self._refs: dict[tuple[int, int], int] = {}
        self.cursor = 0
        self.total_periods = 0
        self.history: list[dict] = []
        self.trace = None
        self._pending_metrics: list[tuple] = []

    def _fresh_state(self) -> TrainState:
        """A worker's state as it starts or joins: the global model in the
        template's dtypes, zero optimizer state, step 0."""
        params = worker_stack(tree_map(lambda g, dt: g.to(dt),
                                       self.server.params, self._dtypes), 1)
        ef, outer = self._policy.init_state(params)
        step = torch.zeros((), dtype=torch.int32, device=self.device)
        return TrainState(params, self.optimizer.init(params), step, ef,
                          outer)

    # ------------------------------------------------------------- schedule
    def _schedule(self, periods: int):
        """Regenerate the full deterministic timeline for ``periods``."""
        cluster = self.scenario.build(self.H)
        ex = AsyncSimExecutor(self.profile, self.plan, cluster,
                              cfg=self.run_cfg.async_cfg)
        trace = ex.run(periods)
        return ex.ops, trace

    # ------------------------------------------------------------------ run
    def run(self, periods: int):
        """Execute the timeline for ``periods`` nominal periods per worker.

        ``periods`` is absolute, not incremental: the op log is a
        deterministic function of (scenario seed, total periods), and the
        work-conserving quota means a *longer* run is not a superset of a
        shorter one — so a runner executes exactly one timeline.  Calling
        ``run`` again with the same total is how a restored runner
        resumes: the already-executed prefix is skipped via the cursor.
        """
        if self.total_periods and periods != self.total_periods:
            raise ValueError(
                f"this runner's timeline was scheduled for "
                f"{self.total_periods} periods; op-log replay cannot "
                f"extend it to {periods} (build a new runner)")
        self.total_periods = periods
        ops, trace = self._schedule(self.total_periods)
        if self.cursor > len(ops):
            raise RuntimeError(
                f"op cursor {self.cursor} beyond regenerated log "
                f"({len(ops)} ops) — scenario/seed mismatch on resume?")
        for op in ops[self.cursor:]:
            if isinstance(op, MergeOp):
                for key in op.contributors:
                    k = (key[0], key[1])
                    self._refs[k] = self._refs.get(k, 0) + 1
        self._run_ops(ops)
        self.trace = trace
        self._drain_metrics()
        if self.ckpt is not None:
            self.ckpt.wait()
        return trace

    # hot path from here to _period_batch: device work, no host read
    @hot_path
    def _run_ops(self, ops) -> None:
        every = self.run_cfg.ckpt_every_merges
        for i in range(self.cursor, len(ops)):
            op = ops[i]
            self._apply_op(op)
            self.cursor = i + 1
            if (self.ckpt is not None and every > 0
                    and isinstance(op, MergeOp)
                    and op.version % every == 0):
                self.save()

    @hot_path
    def _apply_op(self, op) -> None:
        if isinstance(op, PullOp):
            if self.server.version != op.version:
                raise AssertionError(
                    f"pull at version {op.version} but server is at "
                    f"{self.server.version}")
            self._pull(op.worker)
        elif isinstance(op, PeriodOp):
            metrics = self._period(op.worker, op.iter0)
            delta = self._delta(op.worker)
            key = (op.worker, op.period)
            if self._refs.get(key, 0) > 0:
                self._deltas[key] = delta
            self._pending_metrics.append(
                (op.worker, op.period, op.iter0, op.t0, op.t1, metrics))
        elif isinstance(op, PushOp):
            srv = self.locals.setdefault(op.dc, LocalServer(op.dc))
            srv.push(self._deltas[(op.worker, op.period)], op.units,
                     op.base_version, worker=op.worker, period=op.period,
                     phase=op.phase)
        elif isinstance(op, MergeOp):
            self._merge(op)
            for key in op.contributors:
                k = (key[0], key[1])
                self._refs[k] -= 1
                if self._refs[k] == 0:
                    del self._refs[k]
                    self._deltas.pop(k, None)
        elif isinstance(op, JoinOp):
            self.states[op.worker] = self._fresh_state()
        elif isinstance(op, LeaveOp):
            self.states.pop(op.worker, None)
            self._bases.pop(op.worker, None)
        else:
            raise TypeError(f"unknown op {op!r}")

    def _pull(self, worker: int) -> None:
        """The global model into the worker's parameters (cast to their
        dtype) and a float32 clone of it as the worker's delta base."""
        self._bases[worker] = tree_map(torch.clone, self.server.params)
        tree_map(lambda p, g: p[0].copy_(g), self.states[worker].params,
                 self.server.params)

    def _period(self, worker: int, iter0: int) -> dict:
        """One H-step local period of ``worker``, its state updated in
        place; the metrics stay on the device."""
        batch = self._period_batch(worker, iter0)
        st, metrics = self._period_fn(self.states[worker], batch)
        self.states[worker] = st
        return metrics

    def _delta(self, worker: int) -> Tree:
        """``p[0] - base`` in float32, written into the base's buffers."""
        base = self._bases.pop(worker)
        tree_map(lambda p, b: torch.sub(p[0], b, out=b),
                 self.states[worker].params, base)
        return base

    def _merge(self, op: MergeOp) -> None:
        entries = self.locals[op.dc].take(op.contributors)
        delta, units, base = LocalServer.merged_delta(entries)
        if units != op.units:
            raise AssertionError(
                f"merge units {units} != executor's {op.units}")
        tau = self.server.merge(delta, base, units)
        if tau != op.staleness or self.server.version != op.version:
            raise AssertionError(
                f"merge (version {self.server.version}, staleness "
                f"{tau}) disagrees with executor op {op}")

    @hot_path
    def _period_batch(self, worker: int, iter0: int) -> Tree:
        """``{name: [H, 1, B, ...]}`` on the device: worker ``worker``'s
        rows of the data's batches for iterations ``iter0 .. iter0+H-1``
        (a joiner past the data's worker count wraps around)."""
        w = worker % self.data.n_workers
        per_step = [self.data.batch(iter0 + h) for h in range(self.H)]
        batch = {k: torch.stack([b[k][w:w + 1] for b in per_step])
                 for k in per_step[0]}
        return to_device(batch, self.device)

    @hot_path
    def _drain_metrics(self) -> None:
        """One batched host read for everything accumulated this run."""
        if not self._pending_metrics:
            return
        means = torch.stack([m[-1]["loss"].float().mean()
                             for m in self._pending_metrics]).cpu().tolist()
        for (w, p, it0, t0, t1, _), loss in zip(self._pending_metrics,
                                                means, strict=True):
            self.history.append({
                "worker": w, "period": p, "step": it0,
                "t_start": t0, "t_end": t1, "time": t1 - t0,
                "loss": loss,
            })
        self._pending_metrics = []

    # ------------------------------------------------------------ stacking
    def stacked_params(self, n_workers: int | None = None) -> Tree:
        """Global model broadcast to a worker-stacked ``[W, ...]`` view in
        the template's dtypes (what ``Session.state`` / ``serve()``
        consume): one copy of the model, expanded, so later merges do
        not reach it."""
        w = self._n_workers0 if n_workers is None else n_workers
        return tree_map(
            lambda g, dt: g.to(dt, copy=True).unsqueeze(0).expand(
                w, *g.shape), self.server.params, self._dtypes)

    # ---------------------------------------------------------- checkpoint
    def save(self) -> None:
        """Checkpoint at the current (merge-boundary) op cursor."""
        if self.ckpt is None:
            raise ValueError("runner built without a CheckpointManager")
        self._drain_metrics()
        payload = {
            "workers": {str(w): self.states[w]
                        for w in sorted(self.states)},
            "server": self.server.state(),
            "pending": {f"{w}:{p}": self._deltas[(w, p)]
                        for (w, p) in sorted(self._deltas)},
            "bases": {str(w): self._bases[w]
                      for w in sorted(self._bases)},
        }
        meta = {
            "mode": "hier-async",
            "cursor": self.cursor,
            "total_periods": self.total_periods,
            "workers": sorted(self.states),
            "pending": sorted(f"{w}:{p}" for (w, p) in self._deltas),
            "bases": sorted(self._bases),
            "refs": {f"{w}:{p}": n
                     for (w, p), n in sorted(self._refs.items())},
            "locals": {str(dc): self.locals[dc].describe()
                       for dc in sorted(self.locals)},
            "server": self.server.meta(),
            "plan_fingerprint": self.plan.fingerprint(),
            "seed": self.seed,
        }
        self.ckpt.save(self.server.version, payload, meta=meta)

    def restore(self, step: int | None = None) -> int:
        """Resume from a checkpoint; returns the restored global version.

        The op log is regenerated from the scenario seed on the next
        :meth:`run`, so the continuation replays the exact timeline the
        interrupted run would have produced.
        """
        if self.ckpt is None:
            raise ValueError("runner built without a CheckpointManager")
        meta = self.ckpt.peek_meta(step)
        if meta.get("plan_fingerprint") != self.plan.fingerprint():
            raise ValueError("checkpoint was written under a different "
                             "plan; cannot replay its op log")
        zero_delta = tree_map(torch.zeros_like, self.server.params)
        template = {
            "workers": {str(w): self._fresh_state()
                        for w in meta["workers"]},
            "server": self.server.state(),
            "pending": {k: zero_delta for k in meta["pending"]},
            "bases": {str(w): zero_delta for w in meta["bases"]},
        }
        _, payload, meta = self.ckpt.restore(template, step=step)
        self.states = {int(w): st
                       for w, st in payload["workers"].items()}
        self.server.load(payload["server"], meta["server"])
        self._deltas = {}
        for k, delta in payload["pending"].items():
            w, p = k.split(":")
            self._deltas[(int(w), int(p))] = delta
        self._refs = {}
        for k, n in meta["refs"].items():
            w, p = k.split(":")
            self._refs[(int(w), int(p))] = int(n)
        self.locals = {}
        for dc, entries in meta["locals"].items():
            srv = LocalServer(int(dc))
            for e in entries:
                srv.push(self._deltas[(e["worker"], e["period"])],
                         tuple(e["units"]), e["base_version"],
                         worker=e["worker"], period=e["period"],
                         phase=e["phase"])
            self.locals[int(dc)] = srv
        self._bases = {int(w): b for w, b in payload["bases"].items()}
        self._pending_metrics = []
        self.cursor = int(meta["cursor"])
        self.total_periods = int(meta["total_periods"])
        return self.server.version
