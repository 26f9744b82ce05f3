"""AsyncSimExecutor — deterministic event replay of the async runtime.

Each worker loops ``pull -> compute one H-step period locally -> push
per-phase layer-group deltas`` on its *own* virtual clock; nothing ever
blocks at a period boundary.  The executor is a discrete-event machine
over one heap whose ordering key is ``(time, kind-rank, actor, seq)`` —
all four components are deterministic functions of the scenario seed, so
two runs produce byte-identical :class:`~repro_torch.sim.trace.Trace`\\ s and
identical op logs (the determinism contract checkpoint/restart relies
on, see the reference's
``src/repro/hier/DESIGN.md``).

Work is assigned greedily ("work-conserving"): the run targets
``periods * n_initial_workers`` worker-periods in total and each worker
claims the next one the moment it finishes its last.  Under a straggler
the fast workers absorb the slow worker's deficit instead of blocking on
it — that, plus replacing per-phase ring collectives with one
point-to-point pull per period that is *double-buffered* (the next
period's pull is initiated at compute start and hides under the compute;
pushes leave the critical path entirely), is where the async makespan
win over the synchronous executor comes from at equal sample budget.
The prefetched base is read one merge window earlier, which the
staleness-aware merge scale absorbs (``merge.py``).

Scenario events reuse :class:`~repro_torch.sim.events.VirtualCluster` replay:
an event fires when the *minimum* local iteration across active workers
crosses its fire iteration (the synchronous executor's shared iteration
counter degenerates to exactly this).  Straggler slowdowns are read per
worker (:meth:`~repro_torch.sim.events.VirtualCluster.worker_slowdown`);
transient-failure downtime is charged only to the failed worker.

The op log (:class:`PullOp` / :class:`PeriodOp` / :class:`PushOp` /
:class:`MergeOp` / :class:`JoinOp` / :class:`LeaveOp`) totally orders
every state transition of the server tier; the real runner
(:mod:`repro_torch.hier.runner`) replays it to execute the actual training
math in the simulated arrival order.

Framework-free copy of ``repro.hier.executor`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

from ..core.plans import SyncPlan
from ..core.profiler import LayerProfile
from ..sim.events import TransientFailure, VirtualCluster
from ..sim.trace import Interval, Trace
from .merge import MergeConfig, staleness_scale

__all__ = ["AsyncConfig", "AsyncSimExecutor", "PullOp", "PeriodOp",
           "PushOp", "MergeOp", "JoinOp", "LeaveOp"]

# heap ranks: merges land before push arrivals, pushes before pull
# initiations, pulls before period starts at the same instant — so a
# pull always reads the newest version whose time has come, and a
# period start always sees its worker's prefetched pull
_RANK_FLUSH, _RANK_PUSH, _RANK_PULL, _RANK_START = 0, 1, 2, 3


@dataclass(frozen=True)
class AsyncConfig:
    """Knobs of the async tier (the merge math lives in MergeConfig)."""

    pushes_per_merge: int = 1      # local-server flush threshold
    merge: MergeConfig = field(default_factory=MergeConfig)


# ------------------------------------------------------------- op log types
@dataclass(frozen=True)
class PullOp:
    """Worker downloaded the global model (version read at pull start)."""
    t: float
    worker: int
    period: int
    version: int


@dataclass(frozen=True)
class PeriodOp:
    """Worker ran H local steps; ``iter0`` is its first local iteration."""
    t0: float
    t1: float
    worker: int
    period: int
    iter0: int


@dataclass(frozen=True)
class PushOp:
    """One per-phase layer-group delta arrived at datacenter ``dc``."""
    t: float
    worker: int
    period: int
    phase: int
    units: tuple[int, ...]
    base_version: int
    dc: int


@dataclass(frozen=True)
class MergeOp:
    """Local server ``dc`` flushed into the global model.

    ``version`` is the global version *after* the merge; ``staleness``
    is ``version_before - min(contributor base versions)``.
    """
    t: float
    dc: int
    version: int
    staleness: int
    units: tuple[int, ...]
    contributors: tuple[tuple[int, int, int], ...]   # (worker, period, phase)


@dataclass(frozen=True)
class JoinOp:
    t: float
    worker: int


@dataclass(frozen=True)
class LeaveOp:
    t: float
    worker: int


class AsyncSimExecutor:
    """Deterministic async two-tier replay of one plan (module docstring)."""

    def __init__(self, profile: LayerProfile, plan: SyncPlan,
                 cluster: VirtualCluster, *, cfg: AsyncConfig | None = None):
        if plan.n_units != len(profile):
            raise ValueError(
                f"plan has {plan.n_units} units but profile has "
                f"{len(profile)} layers")
        self.profile = profile
        self.plan = plan
        self.cluster = cluster
        self.cfg = cfg or AsyncConfig()
        self.merge_cfg = self.cfg.merge.resolve(cluster.n_active)
        layers = profile.layers
        self._pull_bytes = sum(layers[u].param_bytes
                               for u in plan.all_sync_units())
        self._push_groups = [
            (h, units, sum(layers[u].param_bytes for u in units))
            for h, units in enumerate(plan.phase_units) if units]
        self._compute_base = plan.H * (profile.t_fp_total
                                       + profile.t_bp_total)
        self.ops: list = []
        self.trace: Trace | None = None

    # ----------------------------------------------------------- plumbing
    def _p2p(self, link: str, nbytes: float, start: float) -> float:
        """One point-to-point transfer (pull / push / flush) duration."""
        net = self.cluster.network
        spec = net.link_spec(link)
        dur = net.transfer_time(link, nbytes, start) + spec.latency
        if spec.jitter > 0:
            dur *= 1.0 + spec.jitter * (2.0 * self.cluster.rng.random()
                                        - 1.0)
        return dur

    def _schedule(self, t: float, rank: int, actor: int, payload) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (t, rank, actor, self._seq, payload))

    # ---------------------------------------------------------------- run
    def run(self, periods: int = 1) -> Trace:
        """Replay until ``periods * n_initial_workers`` worker-periods
        have been claimed and every in-flight push has merged."""
        cl = self.cluster
        self._heap = []
        self._seq = 0
        self.ops = []
        self._version = 0
        self._local: dict[int, list] = {}     # dc -> pending push records
        self._stall_credit: dict[int, float] = {}
        self._pull_ready: dict[int, tuple[float, int]] = {}
        self._iters: dict[int, int] = {w: 0 for w in sorted(cl.active)}
        self._periods_done: dict[int, int] = {w: 0 for w in sorted(cl.active)}
        self._known: set[int] = set(cl.active)
        self._left: set[int] = set()
        self._started = 0
        self._target = periods * cl.n_active
        self.staleness_hist: dict[int, int] = {}
        self._merges = 0
        self._final_merge_t = 0.0
        tr = Trace(H=self.plan.H)
        self._tr = tr
        self._spans: list[tuple[float, float]] = []
        self._log_mark = len(cl.log)

        for w in sorted(cl.active):
            self._schedule(0.0, _RANK_START, w, ("start", w))
        while self._heap:
            t, rank, actor, _, payload = heapq.heappop(self._heap)
            if payload[0] == "start":
                self._period_start(t, payload[1])
            elif payload[0] == "push":
                self._push_arrival(t, *payload[1:])
            elif payload[0] == "pull":
                self._pull_start(t, payload[1], payload[2])
            else:
                self._do_merge(t, payload[1], payload[2])

        tr.events.extend(cl.log[self._log_mark:])
        # spans sorted by completion so Trace.makespan (last end) holds
        tr.iteration_spans = sorted(self._spans, key=lambda s: (s[1], s[0]))
        tr.meta.update({
            "mode": "async",
            "n_units": self.plan.n_units,
            "n_workers": len(self._known),
            "n_datacenters": cl.network.topology.n_datacenters,
            "target_periods": self._target,
            "worker_periods": {str(w): self._periods_done[w]
                               for w in sorted(self._periods_done)},
            "merges": self._merges,
            "final_merge_time": self._final_merge_t,
            "merge_rule": self.merge_cfg.rule,
            "pushes_per_merge": self.cfg.pushes_per_merge,
            "staleness_hist": {str(k): v for k, v in
                               sorted(self.staleness_hist.items())},
            "staleness_scale_min": (
                staleness_scale(self.merge_cfg,
                                max(self.staleness_hist, default=0))),
        })
        self.trace = tr
        return tr

    # -------------------------------------------------------------- events
    def _period_start(self, t: float, w: int) -> None:
        cl = self.cluster
        if w not in cl.active:
            return                                 # left while queued
        min_iter = min(self._iters.values()) if self._iters else 0
        fired = cl.advance(min_iter, t)
        cl.take_stall()        # async never stalls the whole cluster
        for ev in fired:
            if isinstance(ev, TransientFailure) and ev.worker in cl.active:
                self._stall_credit[ev.worker] = (
                    self._stall_credit.get(ev.worker, 0.0) + ev.downtime)
        self._membership_diff(t)
        if w not in cl.active:
            return                                 # this very event left
        if self._started >= self._target:
            return                                 # quota exhausted
        self._started += 1
        p = self._periods_done[w]
        it0 = self._iters[w]
        ready = self._pull_ready.pop(w, None)
        stall = self._stall_credit.pop(w, 0.0)
        if ready is None:
            # cold pull (first period, or first after a join): nothing to
            # overlap it with, so it sits on the critical path
            version = self._version
            self.ops.append(PullOp(t, w, p, version))
            dur = self._p2p("intra", self._pull_bytes, t)
            self._tr.intervals.append(
                Interval("pull", it0, -1, -1, t, t + dur, worker=w))
            t0 = t + dur + stall
            stall_at = t + dur
        else:
            # warm pull: prefetched during the previous period's compute
            # (double buffering); version was read at pull initiation
            version = ready[1]
            t0 = max(t + stall, ready[0])
            stall_at = t
        if stall > 0.0:
            self._tr.intervals.append(
                Interval("stall", it0, -1, -1, stall_at, stall_at + stall,
                         worker=w))
        comp = self._compute_base * cl.worker_slowdown(w)
        t1 = t0 + comp
        self._tr.intervals.append(
            Interval("compute", it0, -1, -1, t0, t1, worker=w))
        self.ops.append(PeriodOp(t0, t1, w, p, it0))
        self._spans.append((t, t1))
        # prefetch the next period's pull under this period's compute
        # (a separate event so the version is read at initiation time);
        # speculative — harmless if this worker never claims another
        # period (the runner just installs the pulled model)
        if self._started < self._target:
            self._schedule(t0, _RANK_PULL, w, ("pull", w, p + 1))
        dc = cl.network.topology.dc_of(w)
        pt = t1
        for h, units, nbytes in self._push_groups:
            arr = pt + self._p2p("intra", nbytes, pt)
            self._tr.intervals.append(
                Interval("push", it0, h, -1, pt, arr, worker=w))
            self._schedule(arr, _RANK_PUSH, w,
                           ("push", w, p, h, units, version, dc))
            pt = arr
        self._iters[w] = it0 + self.plan.H
        self._periods_done[w] = p + 1
        self._schedule(t1, _RANK_START, w, ("start", w))

    def _pull_start(self, t: float, w: int, p: int) -> None:
        """Prefetched pull initiation: read the global version *now*."""
        if w not in self.cluster.active:
            return
        version = self._version
        self.ops.append(PullOp(t, w, p, version))
        dur = self._p2p("intra", self._pull_bytes, t)
        self._tr.intervals.append(
            Interval("pull", self._iters.get(w, 0), -1, -1, t, t + dur,
                     worker=w))
        self._pull_ready[w] = (t + dur, version)

    def _membership_diff(self, t: float) -> None:
        cl = self.cluster
        active = set(cl.active)
        for w in sorted(active - self._known):
            self._known.add(w)
            self._iters[w] = 0
            self._periods_done[w] = 0
            self.ops.append(JoinOp(t, w))
            self._schedule(t, _RANK_START, w, ("start", w))
        for w in sorted(self._known - active - self._left):
            self._left.add(w)
            self._iters.pop(w, None)     # excluded from min-iteration
            self._pull_ready.pop(w, None)
            self.ops.append(LeaveOp(t, w))

    def _push_arrival(self, t: float, w: int, p: int, h: int,
                      units: tuple[int, ...], base_version: int,
                      dc: int) -> None:
        self.ops.append(PushOp(t, w, p, h, units, base_version, dc))
        buf = self._local.setdefault(dc, [])
        buf.append((w, p, h, units, base_version))
        if len(buf) < self.cfg.pushes_per_merge:
            return
        entries, self._local[dc] = list(buf), []
        net = self.cluster.network
        if net.topology.n_datacenters > 1:
            flush_units: set[int] = set()
            for e in entries:
                flush_units.update(e[3])
            nbytes = sum(self.profile.layers[u].param_bytes
                         for u in sorted(flush_units))
            dur = self._p2p("inter", nbytes, t)
            self._tr.intervals.append(
                Interval("flush", -1, -1, -1, t, t + dur, worker=dc))
            self._schedule(t + dur, _RANK_FLUSH, dc,
                           ("flush", dc, entries))
        else:
            self._do_merge(t, dc, entries)

    def _do_merge(self, t: float, dc: int, entries: list) -> None:
        base = min(e[4] for e in entries)
        tau = max(0, self._version - base)
        units: set[int] = set()
        for e in entries:
            units.update(e[3])
        self._version += 1
        self._merges += 1
        self._final_merge_t = max(self._final_merge_t, t)
        self.staleness_hist[tau] = self.staleness_hist.get(tau, 0) + 1
        self._tr.intervals.append(
            Interval("merge", -1, -1, -1, t, t, worker=dc))
        self.ops.append(MergeOp(
            t, dc, self._version, tau, tuple(sorted(units)),
            tuple((e[0], e[1], e[2]) for e in entries)))
