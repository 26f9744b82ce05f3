"""Scenario events + the stateful VirtualCluster that replays them.

Events are declarative (frozen dataclasses) and fire at **iteration
boundaries** of the simulated run: each event names either a ``period``
(fires before the first iteration of that period) or an absolute
``iteration``.  Times-of-day are never used — a scenario cannot know wall
clock ahead of the profile it runs against — so durations are expressed
in periods and converted to iterations once ``H`` is known.

The :class:`VirtualCluster` owns all mutable simulation state: the
network, the active worker set, per-worker compute slowdowns, pending
events and the seeded RNG.  Identical (scenario, H, seed) therefore
yields an identical replay — the determinism the conformance suite
asserts byte-for-byte.

Framework-free copy of ``repro.sim.events`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
import random
from dataclasses import dataclass

from ..core.profiler import LayerProfile
from .network import NetworkModel

__all__ = ["ScenarioEvent", "StragglerOnset", "LinkDegradation",
           "BandwidthDrift", "WorkerJoin", "WorkerLeave",
           "TransientFailure", "VirtualCluster", "REPLAN_EVENTS"]


@dataclass(frozen=True)
class ScenarioEvent:
    """Base: when the event fires.  Exactly one of period/iteration."""

    period: int | None = None
    iteration: int | None = None

    def fire_iteration(self, H: int) -> int:
        if (self.period is None) == (self.iteration is None):
            raise ValueError(
                f"{type(self).__name__} needs exactly one of "
                f"period=/iteration= (got {self})")
        return self.iteration if self.iteration is not None \
            else self.period * H

    def describe(self) -> dict:
        d = {k: v for k, v in dataclasses.asdict(self).items()
             if v is not None}
        d["kind"] = type(self).__name__
        return d


@dataclass(frozen=True)
class StragglerOnset(ScenarioEvent):
    """Worker ``worker`` computes ``slowdown``x slower for
    ``duration_periods`` periods (None = for the rest of the run)."""

    worker: int = 0
    slowdown: float = 2.0
    duration_periods: int | None = None


@dataclass(frozen=True)
class LinkDegradation(ScenarioEvent):
    """Multiply a link's bandwidth by ``factor`` for a window."""

    link: str = "inter"
    factor: float = 0.5
    duration_periods: int | None = None


@dataclass(frozen=True)
class BandwidthDrift(ScenarioEvent):
    """Permanently re-base a link's bandwidth (piecewise-constant drift)."""

    link: str = "intra"
    bandwidth: float = 1e9


@dataclass(frozen=True)
class WorkerJoin(ScenarioEvent):
    """``n`` new workers join (lowest unused ids)."""

    n: int = 1


@dataclass(frozen=True)
class WorkerLeave(ScenarioEvent):
    """``n`` workers leave (highest active ids)."""

    n: int = 1


@dataclass(frozen=True)
class TransientFailure(ScenarioEvent):
    """Worker ``worker`` fails and recovers after ``downtime`` seconds;
    synchronous data parallelism stalls the whole iteration."""

    worker: int = 0
    downtime: float = 0.1


#: Event kinds that change the optimal schedule — ``Session.simulate``
#: re-solves the plan when one of these fires (at a period boundary).
REPLAN_EVENTS = (BandwidthDrift, LinkDegradation, WorkerJoin, WorkerLeave)


# internal: closes a duration window opened by a timed event
@dataclass(frozen=True)
class _WindowEnd(ScenarioEvent):
    target: object = None              # event being closed / window handle
    kind: str = ""                     # "straggler" | "degradation"


class VirtualCluster:
    """All mutable state of one simulated geo-cluster run."""

    def __init__(self, network: NetworkModel, events=(), *, H: int,
                 seed: int = 0):
        self.network = network
        self.H = H
        self.rng = random.Random(seed)
        self.active: set[int] = set(range(network.topology.n_workers))
        self._next_worker_id = network.topology.n_workers
        self._slow: dict[int, float] = {}
        self._stall = 0.0
        self.log: list[dict] = []
        self._pending: list[tuple[int, int, ScenarioEvent]] = sorted(
            (ev.fire_iteration(H), i, ev) for i, ev in enumerate(events))
        self._seq = len(self._pending)

    # ------------------------------------------------------------ schedule
    def _push(self, fire_it: int, ev: ScenarioEvent) -> None:
        import bisect
        bisect.insort(self._pending, (fire_it, self._seq, ev))
        self._seq += 1

    # -------------------------------------------------------------- replay
    def advance(self, iteration: int, clock: float) -> list[ScenarioEvent]:
        """Apply every event due at or before ``iteration``; returns the
        user-visible events fired (window-end bookkeeping excluded)."""
        fired: list[ScenarioEvent] = []
        while self._pending and self._pending[0][0] <= iteration:
            fire_it, _, ev = self._pending.pop(0)
            self._apply(ev, fire_it, clock)
            if not isinstance(ev, _WindowEnd):
                fired.append(ev)
        return fired

    def _apply(self, ev: ScenarioEvent, fire_it: int, clock: float) -> None:
        if isinstance(ev, _WindowEnd):
            if ev.kind == "straggler":
                self._slow.pop(ev.target, None)
            else:
                self.network.end_degradation(ev.target, clock)
            return                                     # not logged
        if isinstance(ev, StragglerOnset):
            self._slow[ev.worker] = ev.slowdown
            if ev.duration_periods is not None:
                self._push(fire_it + ev.duration_periods * self.H,
                           _WindowEnd(iteration=0, target=ev.worker,
                                      kind="straggler"))
        elif isinstance(ev, LinkDegradation):
            handle = self.network.degrade(ev.link, ev.factor, clock)
            if ev.duration_periods is not None:
                self._push(fire_it + ev.duration_periods * self.H,
                           _WindowEnd(iteration=0, target=handle,
                                      kind="degradation"))
        elif isinstance(ev, BandwidthDrift):
            self.network.set_bandwidth(ev.link, ev.bandwidth, clock)
        elif isinstance(ev, WorkerJoin):
            for _ in range(ev.n):
                self.active.add(self._next_worker_id)
                self._next_worker_id += 1
        elif isinstance(ev, WorkerLeave):
            if ev.n >= len(self.active):
                raise ValueError("WorkerLeave would empty the cluster")
            for w in sorted(self.active, reverse=True)[:ev.n]:
                self.active.discard(w)
                self._slow.pop(w, None)
        elif isinstance(ev, TransientFailure):
            if ev.worker in self.active:
                self._stall += ev.downtime
        else:
            raise TypeError(f"unknown scenario event {ev!r}")
        self.log.append({"iteration": fire_it, "clock": clock,
                         **ev.describe()})

    def take_stall(self) -> float:
        """Pending whole-cluster stall (transient failures); cleared."""
        s, self._stall = self._stall, 0.0
        return s

    # -------------------------------------------------------------- state
    @property
    def n_active(self) -> int:
        return len(self.active)

    def workers_by_dc(self) -> list[int]:
        return self.network.topology.workers_by_dc(self.active)

    def compute_slowdown(self) -> float:
        """Synchronous DP: the slowest *active* worker gates each layer."""
        return max((self._slow.get(w, 1.0) for w in self.active),
                   default=1.0)

    def worker_slowdown(self, worker: int) -> float:
        """One worker's current compute slowdown (async runtimes charge
        stragglers individually instead of gating on the max)."""
        return self._slow.get(worker, 1.0)

    def collective_time(self, nbytes: float, start: float, *,
                        jittered: bool = True) -> float:
        return self.network.collective_time(
            nbytes, start, workers_by_dc=self.workers_by_dc(),
            rng=self.rng if jittered else None)

    def effective_profile(self, profile: LayerProfile,
                          t: float) -> LayerProfile:
        """The closed-form view of this instant: per-layer comm times from
        the current membership/network at ``t`` (no jitter), compute
        times scaled by the current straggler slowdown.

        This is what the scheduler re-plans against and what the
        conformance layer feeds to ``time_model.simulate_phase``.
        """
        slow = self.compute_slowdown()
        by_dc = self.workers_by_dc()
        layers = [dataclasses.replace(
            c, t_fp=c.t_fp * slow, t_bp=c.t_bp * slow,
            t_comm=self.network.collective_time(
                c.param_bytes, t, workers_by_dc=by_dc))
            for c in profile.layers]
        hw = profile.hw.replace(
            bandwidth=self.network.bandwidth_at("intra", t),
            n_workers=self.n_active)
        return LayerProfile(layers, hw)
