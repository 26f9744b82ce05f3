"""Wall-clock time model of PLSGD (paper Eq. 7/8) + exact event timeline.

Two evaluators are provided for a candidate layer partition:

* :func:`objective` — the paper's Eq. 8 closed form, where a phase's comm time
  is the simple sum of its layers' ``t_comm`` (this is what Algorithm 2's
  pruning properties are stated against);
* :func:`simulate_period` — an exact event-driven timeline honouring the
  per-layer dependency "comm of layer *l* starts only after *l*'s BP completes
  and after the previous comm on the link finishes" (the tau-recursion under
  Eq. 7).  Used to pick among DFS solutions and to build Table 1/Table 2
  style benchmarks, including the S-SGD / WFBP / ASC-WFBP baselines.

Conventions
-----------
Layers are indexed in **network order** 0..L-1 (0 touches the input).  The
backward pass visits them in reverse.  A partition is a tuple of ``H`` counts
``(n_1..n_H)`` summing to L: phase ``h`` synchronizes the ``n_h`` next layers
in *backward* order, so phase 0 always holds the output-most layers — exactly
the interval structure the paper optimizes over (§3.3).

Framework-free copy of ``repro.core.time_model`` (the port imports nothing of
the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from .profiler import LayerProfile

__all__ = [
    "Partition",
    "PhaseTimeline",
    "objective",
    "phase_objective",
    "simulate_phase",
    "simulate_period",
    "ssgd_iteration_time",
    "wfbp_iteration_time",
    "ascwfbp_iteration_time",
    "flsgd_period_time",
]


@dataclass(frozen=True)
class Partition:
    """Contiguous-interval partition of L layers into H phases (BP order)."""

    counts: tuple[int, ...]

    @staticmethod
    def equal_number(n_layers: int, n_phases: int) -> "Partition":
        """The paper's Equal-Number Partition baseline (Example 1)."""
        base, rem = divmod(n_layers, n_phases)
        return Partition(tuple(base + (1 if h < rem else 0)
                               for h in range(n_phases)))

    @property
    def n_phases(self) -> int:
        return len(self.counts)

    @property
    def n_layers(self) -> int:
        return sum(self.counts)

    def bp_intervals(self) -> list[tuple[int, int]]:
        """Per-phase ``[start, end)`` in backward-order positions."""
        out, s = [], 0
        for c in self.counts:
            out.append((s, s + c))
            s += c
        return out

    def layer_ids(self, n_layers: int | None = None) -> list[list[int]]:
        """Per-phase layer ids in *network* order (for SyncPlan building)."""
        n = self.n_layers if n_layers is None else n_layers
        out = []
        for s, e in self.bp_intervals():
            # bp position i corresponds to network layer n-1-i
            out.append(sorted(n - 1 - i for i in range(s, e)))
        return out

    def validate(self) -> None:
        if any(c < 0 for c in self.counts):
            raise ValueError(f"negative phase count in {self.counts}")


# ---------------------------------------------------------------------------
# Paper Eq. 8 (simplified sum-comm objective)
# ---------------------------------------------------------------------------

def _bp_prefix(profile: LayerProfile) -> list[float]:
    """Prefix sums of t_bp in BP order; _bp_prefix[i] = time BP of the first
    i backward layers takes."""
    acc, out = 0.0, [0.0]
    for c in profile.bp_order():
        acc += c.t_bp
        out.append(acc)
    return out


def phase_objective(profile: LayerProfile, partition: Partition,
                    h: int) -> float:
    """Eq. 8 inner term for phase ``h`` (BP part + max(BP-remainder, comm))."""
    bp = profile.bp_order()
    pre = _bp_prefix(profile)
    (s, e) = partition.bp_intervals()[h]
    if s == e:  # empty phase: plain local step
        return pre[-1]
    t_bp_before = pre[s]                    # t_BP^{L_{1:h-1}}
    t_h0 = bp[s].t_bp                       # t_BP^{h0}
    t_bp_rest = pre[-1] - pre[s] - t_h0     # t_BP^{L_{h:H}} - t_BP^{h0}
    t_comm = sum(bp[i].t_comm for i in range(s, e))
    return t_bp_before + t_h0 + max(t_bp_rest, t_comm)


def objective(profile: LayerProfile, partition: Partition,
              include_fp: bool = False) -> float:
    """Paper Eq. 8: one full synchronization period's BP+comm time.

    With ``include_fp`` the H forward passes are added (Eq. 7's ``R x t_FP``
    term per period) — useful for end-to-end iteration-time tables.
    """
    total = sum(phase_objective(profile, partition, h)
                for h in range(partition.n_phases))
    if include_fp:
        total += partition.n_phases * profile.t_fp_total
    return total


# ---------------------------------------------------------------------------
# Exact event-driven timeline (tau-recursion under Eq. 7)
# ---------------------------------------------------------------------------

@dataclass
class PhaseTimeline:
    """One phase's simulated schedule (all times relative to FP end)."""

    bp_done: list[float] = field(default_factory=list)      # per bp position
    comm_start: dict[int, float] = field(default_factory=dict)
    comm_done: dict[int, float] = field(default_factory=dict)
    t_fp: float = 0.0

    @property
    def bp_end(self) -> float:
        return self.bp_done[-1] if self.bp_done else 0.0

    @property
    def comm_end(self) -> float:
        return max(self.comm_done.values(), default=0.0)

    @property
    def iteration_time(self) -> float:
        return self.t_fp + max(self.bp_end, self.comm_end)

    @property
    def exposed_comm(self) -> float:
        """Communication time not hidden by backward compute."""
        return max(0.0, self.comm_end - self.bp_end)

    @property
    def link_idle_before_bp_end(self) -> float:
        """Idle link time inside the BP window (the §3.4 'bubble')."""
        busy = sum(min(self.comm_done[i], self.bp_end)
                   - min(self.comm_start[i], self.bp_end)
                   for i in self.comm_start)
        return max(0.0, self.bp_end - busy)


def simulate_phase(profile: LayerProfile, sync_bp_positions: Sequence[int],
                   *, n_channels: int = 1) -> PhaseTimeline:
    """Simulate one iteration that synchronizes the given BP positions.

    Comm of a layer may start once its BP is done *and* a link channel is
    free; channels model ASC-WFBP-style simultaneous communications
    (``n_channels > 1``).  Layers are communicated in BP-completion order.
    """
    bp = profile.bp_order()
    tl = PhaseTimeline(t_fp=profile.t_fp_total)
    acc = 0.0
    for c in bp:
        acc += c.t_bp
        tl.bp_done.append(acc)
    free_at = [0.0] * max(1, n_channels)
    for i in sorted(sync_bp_positions):
        ch = min(range(len(free_at)), key=free_at.__getitem__)
        start = max(tl.bp_done[i], free_at[ch])
        done = start + bp[i].t_comm
        free_at[ch] = done
        tl.comm_start[i] = start
        tl.comm_done[i] = done
    return tl


def simulate_period(profile: LayerProfile, partition: Partition,
                    fills: Sequence[Sequence[int]] | None = None,
                    *, n_channels: int = 1) -> list[PhaseTimeline]:
    """Simulate all H iterations of one period.

    ``fills[h]`` optionally adds extra BP positions synchronized in phase
    ``h`` (the §3.4 bubble-filling supplement).
    """
    out = []
    for h, (s, e) in enumerate(partition.bp_intervals()):
        positions = set(range(s, e))
        if fills is not None and h < len(fills):
            positions |= set(fills[h])
        out.append(simulate_phase(profile, sorted(positions),
                                  n_channels=n_channels))
    return out


# ---------------------------------------------------------------------------
# Baseline algorithm time models (Table 1 comparisons)
# ---------------------------------------------------------------------------

def ssgd_iteration_time(profile: LayerProfile) -> float:
    """S-SGD, no overlap: FP + BP + full-gradient all-reduce (Eq. 3)."""
    return profile.t_fp_total + profile.t_bp_total + profile.t_comm_total


def wfbp_iteration_time(profile: LayerProfile, *, n_channels: int = 1) -> float:
    """WFBP: per-layer gradient comm launched right after that layer's BP,
    overlapped with remaining BP.  ``n_channels > 1`` models genuinely
    independent links (each at full bandwidth) — use
    :func:`ascwfbp_iteration_time` for the shared-link multi-stream
    baseline."""
    tl = simulate_phase(profile, range(len(profile)), n_channels=n_channels)
    return tl.iteration_time


def ascwfbp_iteration_time(profile: LayerProfile, *, boost: float = 1.25,
                           n_streams: int = 4) -> float:
    """ASC-WFBP [Shi et al. 2021]: simultaneous communications on a SHARED
    link.  Aggregate bandwidth cannot exceed the link; the measured benefit
    (~1.2-1.4x over WFBP) comes from multi-stream utilization and latency
    amortization — modelled as a bounded bandwidth boost + latency / n."""
    hw = profile.hw
    boosted = profile.with_bandwidth(hw.bandwidth * boost,
                                     latency=hw.latency / n_streams)
    return wfbp_iteration_time(boosted)


def flsgd_period_time(profile: LayerProfile, H: int) -> float:
    """Local SGD with full synchronization: H local iters + one full
    non-overlapped model all-reduce (Eq. 4 per period)."""
    return H * (profile.t_fp_total + profile.t_bp_total) + profile.t_comm_total
