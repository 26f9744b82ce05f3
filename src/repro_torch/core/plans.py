"""SyncPlan — the schedule artifact the runtime executes.

A :class:`SyncPlan` is pure data: for each phase ``h`` in a period of ``H``
iterations, the set of layer-unit ids (network order) whose parameters are
averaged across workers in that phase.  It is produced once by a registered
:class:`~repro_torch.api.SyncStrategy` (see :mod:`repro_torch.api`) from a profile,
serialized alongside checkpoints, and re-solved whenever bandwidth or the
worker count changes (elasticity: the schedule is data, not code).

``comm`` distinguishes what is communicated — ``"gradients"`` (classic DDP:
worker-averaged gradients before the optimizer, every iteration) or
``"parameters"`` (local update first, then the phase's units are
parameter-averaged, Eq. 5).  It is set by the strategy that built the plan;
for plans deserialized from older artifacts it is derived from the legacy
algorithm name.

:func:`build_plan` remains as a thin shim over the strategy registry so
existing ``build_plan("dreamddp", ...)`` call sites keep working.

Framework-free copy of ``repro.core.plans`` (the port imports nothing of
the JAX package).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

from .bubble_fill import FillResult
from .profiler import LayerProfile
from .schedule import ScheduleResult

__all__ = ["SyncPlan", "build_plan", "plan_from_partition", "local_plan",
           "local_period_plan", "ALGOS", "GRADIENTS", "PARAMETERS"]

#: The seed algorithm names (kept for backward compatibility; the strategy
#: registry in :mod:`repro_torch.api` is the source of truth and hosts more).
ALGOS = ("ssgd", "wfbp", "ascwfbp", "flsgd", "plsgd-enp", "dreamddp",
         "dreamddp-bf")

GRADIENTS = "gradients"
PARAMETERS = "parameters"

# Legacy algo-name -> comm mode, used only when deserializing plans written
# before ``comm`` existed (or constructed without it).
_LEGACY_GRADIENT_ALGOS = ("ssgd", "wfbp", "ascwfbp")


@dataclass(frozen=True)
class SyncPlan:
    """Executable synchronization schedule for one period."""

    algo: str
    H: int
    n_units: int
    # per phase: sorted tuple of unit ids (network order) to synchronize
    phase_units: tuple[tuple[int, ...], ...]
    # "gradients" | "parameters"; derived from legacy algo names when empty
    comm: str = ""
    # per phase: the subset of phase_units that are §3.4 bubble fills
    fill_units: tuple[tuple[int, ...], ...] = ()
    unit_names: tuple[str, ...] = ()
    objective: float = 0.0
    meta: dict = field(default_factory=dict, compare=False, hash=False)

    def __post_init__(self):
        if not self.comm:
            object.__setattr__(
                self, "comm",
                GRADIENTS if self.algo in _LEGACY_GRADIENT_ALGOS
                else PARAMETERS)
        if self.comm not in (GRADIENTS, PARAMETERS):
            raise ValueError(f"comm must be {GRADIENTS!r} or {PARAMETERS!r},"
                             f" got {self.comm!r}")
        if len(self.phase_units) != self.H:
            raise ValueError(
                f"{len(self.phase_units)} phases for H={self.H}")
        seen: set[int] = set()
        for units in self.phase_units:
            seen.update(units)
        missing = set(range(self.n_units)) - seen
        if missing and self.comm == PARAMETERS and self.algo != "local":
            # "local" plans opt out of the in-step sync path entirely —
            # the async hierarchical runtime reconciles workers through
            # the server tier instead (the async runtime), so Lemma 4's bound
            # is enforced there (staleness clamp), not here.
            raise ValueError(
                f"plan never synchronizes units {sorted(missing)}; every "
                f"layer must sync at least once per period (Lemma 4)")

    # -- queries -------------------------------------------------------------
    def units_for_phase(self, h: int) -> tuple[int, ...]:
        return self.phase_units[h % self.H]

    def phase_of_iteration(self, r: int) -> int:
        return r % self.H

    def period_start(self, r: int) -> int:
        """First iteration of the period containing iteration ``r``."""
        return r - r % self.H

    def all_sync_units(self) -> tuple[int, ...]:
        """Every unit synchronized anywhere in the period (sorted)."""
        out: set[int] = set()
        for units in self.phase_units:
            out.update(units)
        return tuple(sorted(out))

    def phase_segments(self) -> tuple[tuple[int, int], ...]:
        """Period batch layout: maximal runs of consecutive phases whose
        unit sets are identical, as ``(start_phase, length)`` pairs.

        Phases in one segment share the *same* step body (the body
        depends only on the phase's static unit set), so a period-fused
        executor can run each segment as one loop over the
        pre-batched ``[H, ...]`` data instead of unrolling H copies —
        e.g. FLSGD's ``H-1`` local phases + 1 full sync become two
        segments regardless of H.  The phase index stays static per
        segment, so every phase keeps its exact scheduled collective
        bytes and ``segment_cuts`` overlap windows.
        """
        segs: list[tuple[int, int]] = []
        for h in range(self.H):
            if segs and self.phase_units[h] == \
                    self.phase_units[segs[-1][0]]:
                segs[-1] = (segs[-1][0], segs[-1][1] + 1)
            else:
                segs.append((h, 1))
        return tuple(segs)

    def sync_frequency(self) -> list[int]:
        """Per-unit sync count per period (>=1; >1 where fills landed)."""
        counts = [0] * self.n_units
        for units in self.phase_units:
            for u in units:
                counts[u] += 1
        return counts

    @property
    def is_parameter_sync(self) -> bool:
        return self.comm == PARAMETERS

    # -- (de)serialization ----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "algo": self.algo, "comm": self.comm, "H": self.H,
            "n_units": self.n_units,
            "phase_units": [list(u) for u in self.phase_units],
            "fill_units": [list(u) for u in self.fill_units],
            "unit_names": list(self.unit_names),
            "objective": self.objective,
            "meta": self.meta,
        }, indent=1)

    @staticmethod
    def from_json(s: str) -> "SyncPlan":
        o = json.loads(s)
        return SyncPlan(
            algo=o["algo"], comm=o.get("comm", ""), H=o["H"],
            n_units=o["n_units"],
            phase_units=tuple(tuple(u) for u in o["phase_units"]),
            fill_units=tuple(tuple(u) for u in o.get("fill_units", [])),
            unit_names=tuple(o.get("unit_names", ())),
            objective=o.get("objective", 0.0), meta=o.get("meta", {}),
        )

    def fingerprint(self) -> str:
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]


def _bp_positions_to_units(positions, n_units: int) -> tuple[int, ...]:
    """BP position i (0 = output-most) -> network-order unit id."""
    return tuple(sorted(n_units - 1 - p for p in positions))


def plan_from_partition(algo: str, profile: LayerProfile, H: int,
                        result: ScheduleResult,
                        fills: FillResult | None, *,
                        comm: str = PARAMETERS) -> SyncPlan:
    """Materialize a :class:`SyncPlan` from an Algorithm-2 search result.

    Shared by every partition-based strategy (plsgd-enp, dreamddp and its
    registry-provided derivatives).
    """
    n = len(profile)
    intervals = result.partition.bp_intervals()
    phase_units, fill_units = [], []
    for h, (s, e) in enumerate(intervals):
        base = set(range(s, e))
        extra = set(fills.fills[h]) if fills is not None else set()
        phase_units.append(_bp_positions_to_units(base | extra, n))
        fill_units.append(_bp_positions_to_units(extra - base, n))
    return SyncPlan(
        algo=algo, comm=comm, H=H, n_units=n,
        phase_units=tuple(phase_units), fill_units=tuple(fill_units),
        unit_names=tuple(c.name for c in profile.layers),
        objective=result.objective,
        meta={
            "partition_counts": list(result.partition.counts),
            "search_nodes": result.stats.nodes_visited,
            "search_solutions": result.stats.solutions,
            "extra_syncs": fills.extra_syncs if fills else 0,
            "bandwidth": profile.hw.bandwidth,
            "n_workers": profile.hw.n_workers,
        },
    )


def local_plan(n_units: int) -> SyncPlan:
    """A plan whose phase 0 performs **no** synchronization at all.

    Used by the runner for straggler-skipped phases (a pure local step) —
    phase 1 nominally syncs everything so the every-unit-per-period
    invariant holds, but only phase 0 is ever executed.
    """
    return SyncPlan(algo="local", comm=PARAMETERS, H=2, n_units=n_units,
                    phase_units=((), tuple(range(n_units))),
                    fill_units=((), ()))


def local_period_plan(n_units: int, H: int) -> SyncPlan:
    """An H-phase plan that performs no in-step synchronization at all.

    The async hierarchical runtime (``repro.hier``; not ported) executes whole
    periods of pure local steps per worker — reconciliation happens
    through the local/global server tier between periods, not inside the
    step — so every phase's unit set is empty.  ``phase_segments()``
    collapses the H identical phases into one segment, so
    a period executor runs the H identical phases as one segment.
    """
    return SyncPlan(algo="local", comm=PARAMETERS, H=H, n_units=n_units,
                    phase_units=tuple(() for _ in range(H)),
                    fill_units=tuple(() for _ in range(H)))


def build_plan(algo: str, profile: LayerProfile, H: int, *,
               fill_mode: str = "exact") -> SyncPlan:
    """Build the SyncPlan for any registered strategy (registry shim).

    The algorithm dispatch lives in the :mod:`repro_torch.api` strategy registry;
    this function only keeps the historical entry point alive.
    """
    from ..api.registry import available_strategies, get_strategy
    try:
        strategy = get_strategy(algo)
    except KeyError:
        raise ValueError(f"unknown algo {algo!r}; choose from "
                         f"{available_strategies()}") from None
    return strategy.build_plan(profile, H, fill_mode=fill_mode)
