"""Virtual geo-cluster network: links, drift traces, 2-tier topology.

The simulator charges every synchronization collective against a
:class:`NetworkModel` — a two-tier (intra-DC / inter-DC) topology whose
links have piecewise-constant, time-varying bandwidth:

* a declarative :class:`DriftTrace` (the scenario's bandwidth-over-time
  curve, in seconds of simulated time);
* absolute re-bases pushed at event time (:class:`~repro_torch.sim.events
  .BandwidthDrift` fires ``set_bandwidth``);
* multiplicative degradation windows (``degrade`` / ``end_degradation``
  for :class:`~repro_torch.sim.events.LinkDegradation`).

Transfers are integrated exactly over the resulting piecewise-constant
bandwidth function, so a transfer straddling a drift breakpoint takes the
correct integral time — no per-step discretization error.  With a static
link, :meth:`NetworkModel.collective_time` on a flat topology reproduces
:func:`repro_torch.core.profiler.ring_allreduce_time` bit-for-bit, which is what
makes the conformance suite's exact comparisons possible.

Framework-free copy of ``repro.sim.network`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field

__all__ = ["LinkSpec", "DriftTrace", "Topology", "NetworkModel",
           "ring_factor"]

_INF = math.inf


@dataclass(frozen=True)
class LinkSpec:
    """Static description of one link class.

    ``jitter`` is the fractional half-width of a uniform multiplicative
    noise applied per transfer by the cluster's seeded RNG (0 = exact,
    deterministic timing — required by the conformance suite).
    """

    bandwidth: float                   # bytes/s
    latency: float = 0.0               # s per collective stage
    jitter: float = 0.0                # +/- fraction per transfer


@dataclass(frozen=True)
class DriftTrace:
    """Piecewise-constant bandwidth curve over simulated seconds.

    ``breakpoints`` is a sorted tuple of ``(time, bandwidth)``; before the
    first breakpoint the link's base bandwidth applies.
    """

    breakpoints: tuple[tuple[float, float], ...] = ()

    def __post_init__(self):
        ts = [t for t, _ in self.breakpoints]
        if ts != sorted(ts):
            raise ValueError("DriftTrace breakpoints must be time-sorted")

    def value_at(self, t: float, default: float) -> float:
        out = default
        for bt, bw in self.breakpoints:
            if bt <= t:
                out = bw
            else:
                break
        return out

    def times(self) -> list[float]:
        return [t for t, _ in self.breakpoints]


@dataclass(frozen=True)
class Topology:
    """Round-robin assignment of workers to datacenters.

    Worker ``w`` lives in datacenter ``w % n_datacenters`` — round-robin
    (rather than block) assignment keeps datacenters balanced under
    elastic join/leave, which always adds/removes extremal worker ids.
    """

    n_workers: int
    n_datacenters: int = 1

    def __post_init__(self):
        if self.n_workers < 1 or self.n_datacenters < 1:
            raise ValueError("need >= 1 worker and >= 1 datacenter")

    def dc_of(self, worker: int) -> int:
        return worker % self.n_datacenters

    def workers_by_dc(self, active) -> list[int]:
        counts = [0] * self.n_datacenters
        for w in active:
            counts[self.dc_of(w)] += 1
        return counts


def ring_factor(k: int) -> float:
    """Bandwidth-optimal ring all-reduce traffic factor ``2 (K-1)/K``.

    Mirrors :func:`repro_torch.core.profiler.ring_allreduce_time`'s ``K >= 2``
    clamp so a flat static network reproduces profiled comm times exactly.
    """
    k = max(k, 2)
    return 2.0 * (k - 1) / k


@dataclass
class _LinkState:
    """One link class's mutable time-varying bandwidth."""

    spec: LinkSpec
    trace: DriftTrace = field(default_factory=DriftTrace)
    # absolute re-bases: sorted (t_from, bandwidth); overrides trace+spec
    overrides: list[tuple[float, float]] = field(default_factory=list)
    # multiplicative windows: [t0, t1) x factor; t1 = inf until closed
    degradations: list[list[float]] = field(default_factory=list)

    def base_bandwidth_at(self, t: float) -> float:
        if self.overrides:
            i = bisect.bisect_right([o[0] for o in self.overrides], t)
            if i > 0:
                return self.overrides[i - 1][1]
        return self.trace.value_at(t, self.spec.bandwidth)

    def bandwidth_at(self, t: float) -> float:
        bw = self.base_bandwidth_at(t)
        for t0, t1, factor in self.degradations:
            if t0 <= t < t1:
                bw *= factor
        return bw

    def breakpoints_after(self, t: float) -> list[float]:
        pts = set(self.trace.times())
        pts.update(o[0] for o in self.overrides)
        for t0, t1, _ in self.degradations:
            pts.add(t0)
            if t1 != _INF:
                pts.add(t1)
        return sorted(p for p in pts if p > t)


class NetworkModel:
    """Two-tier time-varying network (link classes ``intra`` / ``inter``)."""

    LINKS = ("intra", "inter")

    def __init__(self, topology: Topology, intra: LinkSpec,
                 inter: LinkSpec | None = None, *,
                 drift: dict[str, DriftTrace] | None = None):
        if topology.n_datacenters > 1 and inter is None:
            raise ValueError("multi-datacenter topology needs an inter link")
        self.topology = topology
        drift = drift or {}
        unknown = set(drift) - set(self.LINKS)
        if unknown:
            raise ValueError(f"unknown drift link(s) {sorted(unknown)}")
        self._links = {"intra": _LinkState(intra,
                                           drift.get("intra", DriftTrace()))}
        if inter is not None:
            self._links["inter"] = _LinkState(
                inter, drift.get("inter", DriftTrace()))

    # ------------------------------------------------------------- mutation
    def _link(self, name: str) -> _LinkState:
        try:
            return self._links[name]
        except KeyError:
            raise ValueError(f"no {name!r} link in this topology") from None

    def set_bandwidth(self, link: str, bandwidth: float,
                      t_from: float) -> None:
        """Re-base a link's bandwidth from ``t_from`` onward (drift event)."""
        st = self._link(link)
        if st.overrides and t_from < st.overrides[-1][0]:
            raise ValueError("bandwidth re-bases must be time-ordered")
        st.overrides.append((t_from, bandwidth))

    def degrade(self, link: str, factor: float, t_from: float) -> object:
        """Open a multiplicative degradation window; returns a handle."""
        window = [t_from, _INF, factor]
        self._link(link).degradations.append(window)
        return window

    def end_degradation(self, handle: object, t_end: float) -> None:
        handle[1] = t_end

    # -------------------------------------------------------------- queries
    def link_spec(self, link: str) -> LinkSpec:
        """The static spec of one link class (latency/jitter lookup)."""
        return self._link(link).spec

    def bandwidth_at(self, link: str, t: float) -> float:
        return self._link(link).bandwidth_at(t)

    def transfer_time(self, link: str, nbytes: float, start: float) -> float:
        """Integrate ``nbytes`` over the piecewise-constant bandwidth.

        Zero-bandwidth segments stall the transfer until the next
        breakpoint (an outage window is a degradation with factor 0).
        Latency is *not* included — collectives add it per stage.
        """
        if nbytes <= 0:
            return 0.0
        st = self._link(link)
        remaining = float(nbytes)
        t = start
        pts = st.breakpoints_after(start)
        for nxt in pts + [_INF]:
            bw = st.bandwidth_at(t)
            if bw > 0:
                span = nxt - t
                if remaining <= bw * span:
                    return t + remaining / bw - start
                remaining -= bw * span
            elif nxt == _INF:
                raise RuntimeError(
                    f"{link} link bandwidth is 0 forever from t={t}; "
                    f"transfer can never finish")
            t = nxt
        raise AssertionError("unreachable")

    def collective_time(self, nbytes: float, start: float, *,
                        workers_by_dc: list[int] | None = None,
                        rng=None) -> float:
        """One parameter/gradient all-reduce of ``nbytes`` starting at
        ``start`` with the given active membership.

        Flat topology: one ring over the ``intra`` link.  Two-tier:
        per-DC intra rings (in parallel; the slowest DC gates), then one
        inter-DC ring over the datacenters that hold workers — the
        standard hierarchical all-reduce decomposition.

        ``rng`` (the cluster's seeded RNG) applies each link's jitter as
        a uniform multiplicative factor; ``None`` disables jitter (used
        by the conformance reference, which must be closed-form).
        """
        if workers_by_dc is None:
            workers_by_dc = self.topology.workers_by_dc(
                range(self.topology.n_workers))
        populated = [k for k in workers_by_dc if k > 0]
        total = sum(populated)
        if total == 0:
            raise ValueError("collective with no active workers")

        def stage(link: str, eff_bytes: float, t: float) -> float:
            spec = self._link(link).spec
            dur = self.transfer_time(link, eff_bytes, t) + spec.latency
            if rng is not None and spec.jitter > 0:
                dur *= 1.0 + spec.jitter * (2.0 * rng.random() - 1.0)
            return dur

        if "inter" not in self._links or self.topology.n_datacenters == 1:
            return stage("intra", ring_factor(total) * nbytes, start)

        # two-tier: parallel intra rings, then the inter-DC ring
        intra = max((stage("intra", ring_factor(k) * nbytes, start)
                     if k > 1 else 0.0) for k in populated)
        inter = 0.0
        if len(populated) > 1:
            inter = stage("inter",
                          ring_factor(len(populated)) * nbytes,
                          start + intra)
        return intra + inter
