"""Supplementary communication — "Filling the Bubble Time" (paper §3.4).

After Algorithm 2 fixes the base partition, late phases of a period often
leave the link idle while BP still runs.  DreamDDP fills that idle time with
*extra* synchronizations of the **late layers** (output-most; they converge
last, so extra averaging helps most), subject to Eq. 12: the filled phase's
time must not exceed the unfilled phase's time.

Two admission checks are provided:

* ``mode="eq12"`` — the paper's closed form (Eq. 12), comparing summed comm
  against the BP hiding budget;
* ``mode="exact"`` — event-timeline check via
  :func:`~repro_torch.core.time_model.simulate_phase`: admit the fill only if the
  phase's simulated iteration time does not grow.  Strictly more permissive
  than Eq. 12 is *not* guaranteed — it honours per-layer readiness — so it is
  the default used by the runtime, while benchmarks report both.

Framework-free copy of ``repro.core.bubble_fill`` (the port imports nothing of
the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .profiler import LayerProfile
from .time_model import Partition, simulate_phase

__all__ = ["FillResult", "fill_bubbles"]

_EPS = 1e-12


@dataclass
class FillResult:
    """Extra BP positions synchronized per phase (the §3.4 supplement)."""

    fills: list[list[int]] = field(default_factory=list)   # per phase
    extra_syncs: int = 0                                    # total extra layer-syncs per period

    def sync_counts(self, partition: Partition) -> list[int]:
        """Per-BP-position sync count over one period (>= 1 everywhere)."""
        n = partition.n_layers
        counts = [1] * n
        for fill in self.fills:
            for pos in fill:
                counts[pos] += 1
        return counts


def _phase_hiding_budget(profile: LayerProfile, partition: Partition,
                         h: int) -> float:
    """``t_BP^{L_{h:H}} - t_BP^{h0}`` for phase ``h`` (Eq. 12 LHS budget)."""
    bp = profile.bp_order()
    s, e = partition.bp_intervals()[h]
    if s == e:
        return sum(c.t_bp for c in bp[s:])
    rest = sum(c.t_bp for c in bp[s:])
    return rest - bp[s].t_bp


def fill_bubbles(profile: LayerProfile, partition: Partition, *,
                 mode: str = "exact", n_channels: int = 1) -> FillResult:
    """Greedily add late-layer syncs to every phase, per Eq. 12 / timeline.

    For phase ``h`` the candidate extra set is the paper's ``{L, ..., l}`` —
    a *prefix* of BP positions (output-most layers first), disjoint from the
    phase's own interval.  We grow the prefix while the admission check
    holds, i.e. pick the paper's minimal ``l`` (maximal set).
    """
    if mode not in ("eq12", "exact"):
        raise ValueError(f"unknown fill mode {mode!r}")
    bp = profile.bp_order()
    result = FillResult(fills=[[] for _ in partition.counts])
    intervals = partition.bp_intervals()

    for h, (s, e) in enumerate(intervals):
        own = set(range(s, e))
        if mode == "eq12":
            budget = _phase_hiding_budget(profile, partition, h)
            base_comm = sum(bp[i].t_comm for i in own)
            base_time = max(budget, base_comm)
            extra: list[int] = []
            extra_comm = 0.0
            for pos in range(len(bp)):              # prefix of BP positions
                if pos in own:
                    continue
                cand = extra_comm + bp[pos].t_comm
                if max(budget, base_comm + cand) <= base_time + _EPS:
                    extra.append(pos)
                    extra_comm = cand
                else:
                    break                            # contiguous prefix only
        else:
            base_tl = simulate_phase(profile, sorted(own),
                                     n_channels=n_channels)
            base_time = base_tl.iteration_time
            extra = []
            for pos in range(len(bp)):
                if pos in own:
                    continue
                cand = sorted(own | set(extra) | {pos})
                tl = simulate_phase(profile, cand, n_channels=n_channels)
                if tl.iteration_time <= base_time + _EPS:
                    extra.append(pos)
                else:
                    break
        result.fills[h] = extra
        result.extra_syncs += len(extra)
    return result
