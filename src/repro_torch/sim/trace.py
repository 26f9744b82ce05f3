"""Trace — the simulator's output artifact.

A :class:`Trace` is a flat, append-only list of per-layer compute/comm
:class:`Interval`\\ s plus the applied scenario events and per-iteration
bounds.  It serializes to *canonical* JSON (sorted keys, shortest
round-trip floats), so two runs with identical seeds compare
byte-identical — the determinism contract the test suite pins down with
:meth:`Trace.fingerprint`.

Framework-free copy of ``repro.sim.trace`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

__all__ = ["Interval", "Trace"]


@dataclass(frozen=True)
class Interval:
    """One span of simulated activity.

    ``kind`` is ``fp`` (whole-model forward), ``bp`` (one layer's
    backward), ``comm`` (one unit's all-reduce) or ``stall`` (transient-
    failure wait).  The async runtime adds ``pull`` / ``compute`` /
    ``push`` / ``merge`` spans.  ``unit`` is the network-order layer id,
    or -1 for whole-model spans.  ``worker`` identifies whose timeline
    the span belongs to in async traces (-1 for the synchronous
    executor, where every worker shares one timeline).
    """

    kind: str
    iteration: int
    phase: int
    unit: int
    start: float
    end: float
    worker: int = -1

    @property
    def duration(self) -> float:
        return self.end - self.start

    def to_dict(self) -> dict:
        return {"kind": self.kind, "iteration": self.iteration,
                "phase": self.phase, "unit": self.unit,
                "start": self.start, "end": self.end,
                "worker": self.worker}


@dataclass
class Trace:
    """Full timeline of one simulated run (times in seconds from 0)."""

    H: int
    intervals: list[Interval] = field(default_factory=list)
    events: list[dict] = field(default_factory=list)
    iteration_spans: list[tuple[float, float]] = field(default_factory=list)
    meta: dict = field(default_factory=dict)

    # ------------------------------------------------------------- queries
    @property
    def n_iterations(self) -> int:
        return len(self.iteration_spans)

    @property
    def n_periods(self) -> int:
        return self.n_iterations // self.H

    @property
    def makespan(self) -> float:
        return self.iteration_spans[-1][1] if self.iteration_spans else 0.0

    def iteration_time(self, r: int) -> float:
        s, e = self.iteration_spans[r]
        return e - s

    def period_start(self, p: int) -> float:
        return self.iteration_spans[p * self.H][0]

    def period_time(self, p: int) -> float:
        return (self.iteration_spans[(p + 1) * self.H - 1][1]
                - self.iteration_spans[p * self.H][0])

    def period_times(self) -> list[float]:
        return [self.period_time(p) for p in range(self.n_periods)]

    def of_kind(self, kind: str, iteration: int | None = None
                ) -> list[Interval]:
        return [iv for iv in self.intervals if iv.kind == kind
                and (iteration is None or iv.iteration == iteration)]

    def exposed_comm(self, r: int) -> float:
        """Comm time of iteration ``r`` not hidden under its backward."""
        bps = self.of_kind("bp", r)
        bp_end = max((iv.end for iv in bps), default=0.0)
        comm_end = max((iv.end for iv in self.of_kind("comm", r)),
                       default=bp_end)
        return max(0.0, comm_end - bp_end)

    def total_exposed_comm(self) -> float:
        return sum(self.exposed_comm(r) for r in range(self.n_iterations))

    # ------------------------------------------------------ serialization
    def to_dict(self) -> dict:
        return {
            "H": self.H,
            "intervals": [iv.to_dict() for iv in self.intervals],
            "events": self.events,
            "iteration_spans": [list(s) for s in self.iteration_spans],
            "meta": self.meta,
        }

    def to_json(self) -> str:
        """Canonical JSON: identical replays are byte-identical."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @staticmethod
    def from_json(s: str) -> "Trace":
        o = json.loads(s)
        return Trace(
            H=o["H"],
            intervals=[Interval(**iv) for iv in o["intervals"]],
            events=o["events"],
            iteration_spans=[tuple(x) for x in o["iteration_spans"]],
            meta=o["meta"],
        )

    def fingerprint(self) -> str:
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]
