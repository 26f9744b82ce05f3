"""Async-conformance checking: AsyncSimExecutor vs a heap-free reference.

The async time model is simple enough to state in closed form — workers
never block on each other, so each worker-period computes for

    H * (t_fp_total + t_bp_total) * slowdown_w

starting at ``max(claim + stall_w, pull_ready_w)``, where the pull is
*double-buffered*: a worker's first pull (cold, after start or join)
sits on its critical path, and every later pull was initiated at the
previous period's compute start and usually hides under it.  The
makespan is the max worker clock over a *greedy* assignment of the
``periods * n_initial_workers`` worker-period quota (next free worker,
ties by id).  :func:`reference_async_spans` re-derives every
worker-period span with a direct argmin loop — no event heap, no push
or merge machinery — against a replica
:class:`~repro_torch.sim.events.VirtualCluster` for scenario-event state, the
same replica-replay idiom :func:`repro_torch.sim.conformance.check_scenario`
uses for the synchronous executor.  :func:`check_async_scenario` then
pins the executor's trace to that reference span-by-span.

Because the reference shares none of the executor's queue/arrival
bookkeeping, agreement (to float round-off; ``rtol`` = 1e-6 like the
sync layer) validates the heap ordering, quota accounting, membership
diffing and per-worker stall attribution all at once.  Jittered
scenarios are rejected, exactly as in the sync layer: their timing is
seeded noise by construction.

Framework-free copy of ``repro.hier.conformance`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.plans import SyncPlan
from ..core.profiler import LayerProfile
from ..sim.conformance import DEFAULT_RTOL, WindowCheck, synthetic_profile
from ..sim.events import TransientFailure
from ..sim.executor import prepare_run
from ..sim.trace import Trace
from .executor import AsyncConfig, AsyncSimExecutor

__all__ = ["AsyncConformanceReport", "reference_async_spans",
           "check_async_scenario", "check_async_library"]


@dataclass
class AsyncConformanceReport:
    scenario: str
    algo: str
    H: int
    checks: list[WindowCheck] = field(default_factory=list)
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
                f"spans={len(self.checks)} "
                f"max_rel_err={self.max_rel_err:.2e} {status}")


def reference_async_spans(scenario, plan: SyncPlan, profile: LayerProfile,
                          periods: int) -> list[tuple[float, float]]:
    """Heap-free greedy reference for the async worker-period spans."""
    cl = scenario.build(plan.H)
    net = cl.network
    lat = net.link_spec("intra").latency
    layers = profile.layers
    pull_bytes = sum(layers[u].param_bytes for u in plan.all_sync_units())
    compute_base = plan.H * (profile.t_fp_total + profile.t_bp_total)

    pending = {w: 0.0 for w in sorted(cl.active)}
    iters = {w: 0 for w in sorted(cl.active)}
    known, left = set(cl.active), set()
    credits: dict[int, float] = {}
    ready: dict[int, float] = {}       # prefetched-pull completion times
    target = periods * cl.n_active
    started = 0
    spans: list[tuple[float, float]] = []

    def pull(at: float) -> float:
        return net.transfer_time("intra", pull_bytes, at) + lat

    while pending and started < target:
        w = min(sorted(pending), key=lambda a: (pending[a], a))
        t = pending.pop(w)
        if w not in cl.active:
            continue
        min_iter = min(iters.values()) if iters else 0
        fired = cl.advance(min_iter, t)
        cl.take_stall()
        for ev in fired:
            if isinstance(ev, TransientFailure) and ev.worker in cl.active:
                credits[ev.worker] = (credits.get(ev.worker, 0.0)
                                      + ev.downtime)
        active = set(cl.active)
        for w2 in sorted(active - known):
            known.add(w2)
            iters[w2] = 0
            pending[w2] = t
        for w2 in sorted(known - active - left):
            left.add(w2)
            iters.pop(w2, None)
            pending.pop(w2, None)
            ready.pop(w2, None)
        if w not in cl.active:
            continue
        started += 1
        stall = credits.pop(w, 0.0)
        if w in ready:
            t0 = max(t + stall, ready.pop(w))     # warm (prefetched) pull
        else:
            t0 = t + pull(t) + stall              # cold pull
        t1 = t0 + compute_base * cl.worker_slowdown(w)
        ready[w] = t0 + pull(t0)                  # prefetch the next pull
        spans.append((t, t1))
        iters[w] += plan.H
        pending[w] = t1
    return sorted(spans, key=lambda s: (s[1], s[0]))


def check_async_scenario(scenario, *, algo: str = "dreamddp", H: int = 4,
                         profile: LayerProfile | None = None,
                         periods: int | None = None,
                         cfg: AsyncConfig | None = None,
                         rtol: float = DEFAULT_RTOL,
                         fill_mode: str = "exact"
                         ) -> AsyncConformanceReport:
    """Run a scenario async and pin every worker-period span."""
    from ..api.registry import get_strategy

    if any(spec.jitter > 0 for spec in
           (scenario.intra, scenario.inter) if spec is not None):
        raise ValueError(
            f"scenario {scenario.name!r} has link jitter; its timing is "
            f"seeded noise and cannot be conformance-checked")
    if profile is None:
        profile = synthetic_profile()
    periods = scenario.periods if periods is None else periods

    cluster, plan = prepare_run(scenario, get_strategy(algo), H, profile,
                                fill_mode=fill_mode)
    ex = AsyncSimExecutor(profile, plan, cluster, cfg=cfg)
    trace = ex.run(periods)

    report = AsyncConformanceReport(scenario=scenario.name, algo=algo,
                                    H=plan.H, trace=trace)
    expected = reference_async_spans(scenario, plan, profile, periods)
    simulated = trace.iteration_spans
    if len(expected) != len(simulated):
        raise AssertionError(
            f"reference produced {len(expected)} worker-periods but the "
            f"executor produced {len(simulated)}")
    for i, ((es, ee), (ss, se)) in enumerate(zip(expected, simulated)):
        report.checks.append(WindowCheck(period=i, expected=es,
                                         simulated=ss, rtol=rtol))
        report.checks.append(WindowCheck(period=i, expected=ee,
                                         simulated=se, rtol=rtol))
    return report


def check_async_library(*, algos=("dreamddp",), H: int = 4,
                        profile: LayerProfile | None = None,
                        rtol: float = DEFAULT_RTOL
                        ) -> list[AsyncConformanceReport]:
    """Async-conformance-check every jitter-free library scenario."""
    from ..sim.scenarios import available_scenarios, get_scenario

    reports = []
    for name in available_scenarios():
        sc = get_scenario(name)
        if any(spec.jitter > 0 for spec in (sc.intra, sc.inter)
               if spec is not None):
            continue
        for algo in algos:
            reports.append(check_async_scenario(sc, algo=algo, H=H,
                                                profile=profile, rtol=rtol))
    return reports
