"""Schedule-conformance checking: SimExecutor vs the closed-form model.

The simulator and :mod:`repro_torch.core.time_model` are two independent
implementations of the same timing semantics (the Eq. 7 tau-recursion).
This module pins them against each other: for every *static window* of a
scenario — a period during which no event fires mid-period and no drift
breakpoint lands inside — the simulated period time must equal

    stall + sum_h simulate_phase(effective_profile, positions_h)

within ``rtol`` (default 1e-6 relative; in practice they agree to float
round-off, ~1e-12).  ``effective_profile`` is the cluster's closed-form
view at the window start: comm times from the hierarchical ring model at
the current membership/bandwidth, compute times scaled by the current
straggler slowdown.  Transient-failure stalls are additive and known, so
they are moved to the expected side.

Scenarios with link jitter cannot be checked (their timing is seeded
noise by construction) — :func:`check_scenario` rejects them.

Framework-free copy of ``repro.sim.conformance`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

from ..core.profiler import HardwareSpec, LayerProfile, analytic_profile
from ..core.time_model import simulate_phase
from .executor import SimExecutor, prepare_run
from .trace import Trace

__all__ = ["WindowCheck", "ConformanceReport", "synthetic_profile",
           "reference_period_time", "check_scenario", "check_library",
           "DEFAULT_RTOL"]

DEFAULT_RTOL = 1e-6


def synthetic_profile(n_layers: int = 12, *, seed: int = 0,
                      bandwidth: float = 1e9, n_workers: int = 8,
                      latency: float = 1e-4) -> LayerProfile:
    """Deterministic random-ish profile for scenario/conformance runs."""
    rng = random.Random(seed)
    hw = HardwareSpec(bandwidth=bandwidth, n_workers=n_workers,
                      latency=latency)
    layers = [(f"l{i}", rng.uniform(1e6, 5e7), rng.uniform(1e9, 8e10))
              for i in range(n_layers)]
    return analytic_profile(layers, hw)


@dataclass(frozen=True)
class WindowCheck:
    """One static-window comparison."""

    period: int
    expected: float
    simulated: float
    rtol: float

    @property
    def rel_err(self) -> float:
        scale = max(abs(self.expected), 1e-30)
        return abs(self.simulated - self.expected) / scale

    @property
    def ok(self) -> bool:
        return self.rel_err <= self.rtol


@dataclass
class ConformanceReport:
    scenario: str
    algo: str
    H: int
    checks: list[WindowCheck] = field(default_factory=list)
    skipped_periods: list[int] = field(default_factory=list)
    trace: Trace | None = None

    @property
    def ok(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)

    @property
    def max_rel_err(self) -> float:
        return max((c.rel_err for c in self.checks), default=float("nan"))

    def summary(self) -> str:
        status = "OK" if self.ok else "FAIL"
        return (f"{self.scenario:<20} {self.algo:<12} H={self.H} "
                f"windows={len(self.checks)} skipped="
                f"{len(self.skipped_periods)} "
                f"max_rel_err={self.max_rel_err:.2e} {status}")


def reference_period_time(profile: LayerProfile, positions_per_phase,
                          *, n_channels: int = 1) -> float:
    """Closed-form period time of an arbitrary per-phase position plan."""
    return sum(simulate_phase(profile, pos,
                              n_channels=n_channels).iteration_time
               for pos in positions_per_phase)


def _event_boundaries(scenario, H: int) -> list[int]:
    """All iterations at which scenario state changes (incl. window ends)."""
    out = []
    for ev in scenario.events:
        fire = ev.fire_iteration(H)
        out.append(fire)
        dur = getattr(ev, "duration_periods", None)
        if dur is not None:
            out.append(fire + dur * H)
    return sorted(out)


def _static_periods(scenario, H: int, trace: Trace) -> tuple[list[int],
                                                             list[int]]:
    """Periods whose cluster/network state is constant throughout."""
    boundaries = _event_boundaries(scenario, H)
    drift_times: list[float] = []
    for tr in (scenario.drift or {}).values():
        drift_times.extend(tr.times())
    static, skipped = [], []
    for p in range(trace.n_periods):
        lo, hi = p * H, (p + 1) * H
        t0 = trace.period_start(p)
        t1 = trace.iteration_spans[hi - 1][1]
        mid_event = any(lo < b < hi for b in boundaries)
        mid_drift = any(t0 < t < t1 for t in drift_times)
        (skipped if (mid_event or mid_drift) else static).append(p)
    return static, skipped


def check_scenario(scenario, *, algo: str = "dreamddp", H: int = 4,
                   profile: LayerProfile | None = None,
                   n_channels: int = 1, rtol: float = DEFAULT_RTOL,
                   fill_mode: str = "exact") -> ConformanceReport:
    """Run a scenario and compare every static window to the time model."""
    from ..api.registry import get_strategy

    if any(spec.jitter > 0 for spec in
           (scenario.intra, scenario.inter) if spec is not None):
        raise ValueError(
            f"scenario {scenario.name!r} has link jitter; its timing is "
            f"seeded noise and cannot be conformance-checked")
    if profile is None:
        profile = synthetic_profile()

    cluster, plan = prepare_run(scenario, get_strategy(algo), H, profile,
                                fill_mode=fill_mode)
    ex = SimExecutor(profile, plan, cluster, n_channels=n_channels)
    trace = ex.run(scenario.periods)

    report = ConformanceReport(scenario=scenario.name, algo=algo, H=plan.H,
                               trace=trace)
    static, report.skipped_periods = _static_periods(scenario, plan.H,
                                                     trace)
    # A replica cluster replayed iteration-by-iteration (with the trace's
    # actual clocks) gives the closed-form view; per-iteration advancing
    # attributes transient-failure stalls to the period they fired in.
    # Built with the plan's actual period length so event conversion and
    # window bookkeeping line up even when the strategy forced H.
    ref = scenario.build(plan.H)
    stall_by_period = [0.0] * trace.n_periods
    eff_by_period: dict[int, LayerProfile] = {}
    for r in range(trace.n_periods * plan.H):
        t_r = trace.iteration_spans[r][0]
        ref.advance(r, t_r)
        p = r // plan.H
        stall_by_period[p] += ref.take_stall()
        if r % plan.H == 0 and p in static:
            eff_by_period[p] = ref.effective_profile(profile, t_r)
    for p in static:
        expected = stall_by_period[p] + reference_period_time(
            eff_by_period[p], ex.positions_per_phase,
            n_channels=n_channels)
        report.checks.append(WindowCheck(
            period=p, expected=expected, simulated=trace.period_time(p),
            rtol=rtol))
    return report


def check_library(*, algos=("dreamddp", "plsgd-enp", "flsgd"), H: int = 4,
                  profile: LayerProfile | None = None,
                  rtol: float = DEFAULT_RTOL) -> list[ConformanceReport]:
    """Conformance-check every library scenario under several strategies."""
    from .scenarios import available_scenarios, get_scenario

    reports = []
    for name in available_scenarios():
        for algo in algos:
            reports.append(check_scenario(get_scenario(name), algo=algo,
                                          H=H, profile=profile, rtol=rtol))
    return reports
