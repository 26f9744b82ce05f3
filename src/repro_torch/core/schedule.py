"""DreamDDP schedule search (paper §3.3, Algorithm 2).

Given a :class:`~repro_torch.core.profiler.LayerProfile` and a synchronization
period ``H``, find the contiguous-interval partition of the ``L`` layer units
into ``H`` phases that minimizes the paper's Eq. 8 per-period time.

Three search strategies are provided:

* :func:`brute_force_schedule` — exhaustive enumeration of all
  ``C(L+H-1, H-1)``-ish interval partitions (paper's reference optimum,
  Fig. 15); only feasible for small ``L``.
* :func:`dreamddp_schedule` — Algorithm 2: a DFS whose branching is pruned by
  the three properties *Optimal Hiding* (Property 1), *Delayed CO Assignment*
  (Property 2) and *At-Least-One Assignment* (Property 3), reducing the
  solution-set size to ``O(2^min(L-H, H))``.
* :func:`enp_schedule` — the Equal-Number Partition baseline (Example 1,
  PLSGD-ENP in the paper's tables).

All schedulers reason in **backward order** (position 0 = output-most layer),
matching the paper: phase 1 synchronizes the layers whose BP finishes first.

Search statistics (solutions enumerated, recursion nodes) are returned so the
Fig. 16 complexity benchmark reads real counters instead of re-deriving
formulas.

Framework-free copy of ``repro.core.schedule`` (the port imports nothing of
the JAX package).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from .profiler import LayerProfile
from .time_model import Partition, objective, simulate_period

__all__ = [
    "ScheduleResult",
    "SearchStats",
    "brute_force_schedule",
    "dreamddp_schedule",
    "enp_schedule",
    "brute_force_count",
]


@dataclass
class SearchStats:
    """Counters for the Fig. 16 search-complexity comparison."""

    nodes_visited: int = 0          # recursion invocations
    solutions: int = 0              # size of the solution set Omega
    aloha_hits: int = 0             # Property 3 (at-least-one) applications
    optimal_hiding_hits: int = 0    # Property 1 applications
    delayed_co_hits: int = 0        # Property 2 applications
    branch_hits: int = 0            # un-pruned DFS branches


@dataclass
class ScheduleResult:
    """Outcome of a schedule search."""

    partition: Partition
    objective: float                 # Eq. 8 value of the chosen partition
    stats: SearchStats = field(default_factory=SearchStats)

    @property
    def counts(self) -> tuple[int, ...]:
        return self.partition.counts


# ---------------------------------------------------------------------------
# Brute force (paper's reference optimum, Fig. 15)
# ---------------------------------------------------------------------------

def brute_force_count(n_layers: int, n_phases: int) -> int:
    """Number of weak compositions of L into H parts = C(L+H-1, H-1)."""
    from math import comb

    return comb(n_layers + n_phases - 1, n_phases - 1)


def _compositions(total: int, parts: int):
    """All weak compositions of ``total`` into ``parts`` non-negative ints."""
    if parts == 1:
        yield (total,)
        return
    for first in range(total + 1):
        for rest in _compositions(total - first, parts - 1):
            yield (first,) + rest


def brute_force_schedule(profile: LayerProfile, H: int) -> ScheduleResult:
    """Exhaustively minimize Eq. 8 over all interval partitions."""
    L = len(profile)
    stats = SearchStats()
    best, best_val = None, float("inf")
    for counts in _compositions(L, H):
        stats.solutions += 1
        part = Partition(counts)
        val = objective(profile, part)
        if val < best_val - 1e-15:
            best, best_val = part, val
    stats.nodes_visited = stats.solutions
    assert best is not None
    return ScheduleResult(best, best_val, stats)


# ---------------------------------------------------------------------------
# Equal-Number Partition (paper Example 1; PLSGD-ENP baseline)
# ---------------------------------------------------------------------------

def enp_schedule(profile: LayerProfile, H: int) -> ScheduleResult:
    part = Partition.equal_number(len(profile), H)
    return ScheduleResult(part, objective(profile, part))


# ---------------------------------------------------------------------------
# Algorithm 2: pruned DFS
# ---------------------------------------------------------------------------

class _DFS:
    """State for one Algorithm-2 search (times pre-extracted, BP order)."""

    def __init__(self, profile: LayerProfile, H: int,
                 max_solutions: int | None):
        bp = profile.bp_order()
        self.L = len(bp)
        self.H = H
        self.t_bp = [c.t_bp for c in bp]           # index = BP position
        self.t_comm = [c.t_comm for c in bp]
        self.t_bp_total = sum(self.t_bp)
        # suffix[i] = sum of t_bp for BP positions >= i  (= t_BP^{L_{h:H}}
        # when position i is the first layer of phase h's interval start)
        self.bp_suffix = [0.0] * (self.L + 1)
        for i in range(self.L - 1, -1, -1):
            self.bp_suffix[i] = self.bp_suffix[i + 1] + self.t_bp[i]
        self.stats = SearchStats()
        self.solutions: list[tuple[int, ...]] = []
        self.max_solutions = max_solutions

    # -- helper terms -------------------------------------------------------
    def _bp_rest_minus_h0(self, start: int) -> float:
        """``t_BP^{L_{h:H}} - t_BP^{h0}`` for a phase whose interval starts at
        BP position ``start``.  All layers from ``start`` to the input run
        their BP in this iteration; the first layer's own BP cannot overlap
        its own communication."""
        return self.bp_suffix[start] - self.t_bp[start]

    def run(self) -> None:
        # partition under construction: counts per phase (BP order)
        self._solve(next_pos=0, h=0, counts=[], cur=0, cur_comm=0.0,
                    cur_start=0)

    def _record(self, counts: list[int], cur: int) -> None:
        out = counts + [cur]
        # pad trailing empty phases
        out += [0] * (self.H - len(out))
        self.solutions.append(tuple(out))
        self.stats.solutions += 1

    def _full(self) -> bool:
        return (self.max_solutions is not None
                and len(self.solutions) >= self.max_solutions)

    def _solve(self, next_pos: int, h: int, counts: list[int], cur: int,
               cur_comm: float, cur_start: int) -> None:
        """Assign BP positions ``next_pos..L-1`` to phases ``h..H-1``.

        ``cur``/``cur_comm``/``cur_start`` describe the (open) phase ``h``:
        number of layers so far, their summed comm time, and the BP position
        of the phase's first (output-most) layer.
        """
        if self._full():
            return
        self.stats.nodes_visited += 1
        if next_pos == self.L:                       # all layers assigned
            self._record(counts, cur)
            return
        if h == self.H - 1:                          # last phase takes rest
            self._record(counts, cur + (self.L - next_pos))
            return

        l = next_pos
        if cur == 0:
            # Property 3 (At-Least-One): an empty phase always takes the
            # next layer — assigning it cannot be worse than delaying.
            self.stats.aloha_hits += 1
            self._solve(l + 1, h, counts, 1, self.t_comm[l], l)
            return

        hide_budget = self._bp_rest_minus_h0(cur_start)
        if hide_budget >= cur_comm + self.t_comm[l]:
            # Property 1 (Optimal Hiding): the extra comm is still fully
            # hidden -> taking the layer now is never worse.
            self.stats.optimal_hiding_hits += 1
            self._solve(l + 1, h, counts, cur + 1,
                        cur_comm + self.t_comm[l], cur_start)
            return
        if hide_budget < cur_comm:
            # Property 2 (Delayed CO Assignment): this phase already
            # overflows; adding more comm only grows the overflow.  Close
            # the phase and delay layer ``l``.
            self.stats.delayed_co_hits += 1
            self._solve(l, h + 1, counts + [cur], 0, 0.0, l)
            return

        # Un-pruned case: branch (true DFS).
        self.stats.branch_hits += 1
        # branch A: assign l to phase h (overflows it)
        self._solve(l + 1, h, list(counts), cur + 1,
                    cur_comm + self.t_comm[l], cur_start)
        # branch B: close phase h, delay l to phase h+1
        self._solve(l, h + 1, counts + [cur], 0, 0.0, l)


def dreamddp_schedule(profile: LayerProfile, H: int, *,
                      refine_exact: bool = True,
                      max_solutions: int | None = 200_000) -> ScheduleResult:
    """Algorithm 2: pruned DFS over interval partitions.

    ``refine_exact`` re-ranks the best few candidates with the exact
    event-driven timeline (:func:`~repro_torch.core.time_model.simulate_period`),
    which breaks Eq. 8 ties in favour of schedules whose tau-recursion
    (per-layer comm serialization) is cheaper.
    """
    if H <= 0:
        raise ValueError(f"H must be positive, got {H}")
    L = len(profile)
    if L == 0:
        raise ValueError("empty profile")
    if H == 1:
        # Degenerate: everything in one phase (== FLSGD with overlap).
        part = Partition((L,))
        return ScheduleResult(part, objective(profile, part))
    H_eff = min(H, L)  # at most one layer per phase is meaningful

    dfs = _DFS(profile, H_eff, max_solutions)
    dfs.run()
    assert dfs.solutions, "Algorithm 2 produced no candidate partitions"

    scored = []
    for counts in dfs.solutions:
        counts = counts + (0,) * (H - H_eff)
        part = Partition(counts)
        scored.append((objective(profile, part), part))
    scored.sort(key=lambda t: t[0])

    best_val, best = scored[0]
    if refine_exact and len(scored) > 1:
        # exact-timeline re-rank among near-ties (within 1% of Eq. 8 min)
        cutoff = best_val * (1.0 + 1e-2) + 1e-12
        cands = [p for v, p in scored if v <= cutoff][:64]
        def exact(p: Partition) -> float:
            return sum(tl.iteration_time
                       for tl in simulate_period(profile, p))
        best = min(cands, key=exact)
        best_val = objective(profile, best)

    return ScheduleResult(best, best_val, dfs.stats)
