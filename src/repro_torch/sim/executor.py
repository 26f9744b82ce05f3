"""SimExecutor — replay a SyncPlan against a virtual geo-cluster.

The executor drives the *real* schedule artifact
(:class:`~repro_torch.core.plans.SyncPlan` — any registered strategy's output,
not just interval partitions) through a :class:`~repro_torch.sim.events
.VirtualCluster`:

* compute times come from the :class:`~repro_torch.core.profiler.LayerProfile`
  (scaled by the cluster's current straggler slowdown);
* comm times come from the plan's **bytes** — each synchronized unit's
  ``param_bytes`` charged as a hierarchical ring all-reduce against the
  time-varying :class:`~repro_torch.sim.network.NetworkModel` at the instant
  the transfer starts;
* the per-layer dependency is the paper's tau-recursion (Eq. 7): a
  unit's comm starts once its backward finishes *and* a link channel is
  free, in backward-completion order.

On a static network this reproduces
:func:`repro_torch.core.time_model.simulate_phase` exactly — the conformance
suite (:mod:`repro_torch.sim.conformance`) pins that equivalence down per
scenario — while scenario events (drift, stragglers, churn, failures)
take the timeline places the closed form cannot go.

Framework-free copy of ``repro.sim.executor`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

from ..core.plans import SyncPlan
from ..core.profiler import LayerProfile
from .events import ScenarioEvent, VirtualCluster
from .trace import Interval, Trace

__all__ = ["SimExecutor", "SimReport", "prepare_run"]


def prepare_run(scenario, strategy, H: int, profile: LayerProfile, *,
                fill_mode: str = "exact"):
    """Solve a strategy's plan for a scenario's network at t=0.

    Returns ``(cluster, plan)`` ready for :class:`SimExecutor`.  When the
    strategy forces a different period length (gradient-sync strategies
    return ``H == 1``), the cluster is rebuilt with the plan's actual
    ``H`` so scenario-event period conversion stays aligned.  Shared by
    ``Session.simulate`` and the conformance checker so both always
    agree on which cluster a plan runs against.
    """
    cluster = scenario.build(H)
    plan = strategy.build_plan(cluster.effective_profile(profile, 0.0),
                               H, fill_mode=fill_mode)
    if plan.H != H:
        cluster = scenario.build(plan.H)
    return cluster, plan

#: callback: (executor, events fired at a period boundary) -> replacement
#: plan or None.  Used by ``Session.simulate`` to re-plan after drift.
OnEvents = Callable[["SimExecutor", Sequence[ScenarioEvent]],
                    SyncPlan | None]


@dataclass
class SimReport:
    """What ``Session.simulate`` returns: trace + plan history."""

    scenario: str
    trace: Trace
    plans: list[tuple[int, SyncPlan]] = field(default_factory=list)

    @property
    def final_plan(self) -> SyncPlan:
        return self.plans[-1][1]

    @property
    def replanned(self) -> bool:
        return len(self.plans) > 1

    def summary(self) -> dict:
        t = self.trace
        return {
            "scenario": self.scenario,
            "periods": t.n_periods,
            "makespan_s": t.makespan,
            "period_times_s": t.period_times(),
            "mean_iteration_s": (t.makespan / t.n_iterations
                                 if t.n_iterations else 0.0),
            "exposed_comm_s": t.total_exposed_comm(),
            "replans": len(self.plans) - 1,
            "events": len(t.events),
        }


class SimExecutor:
    """Discrete-event replay of one plan's period timeline."""

    def __init__(self, profile: LayerProfile, plan: SyncPlan,
                 cluster: VirtualCluster, *, n_channels: int = 1):
        if plan.n_units != len(profile):
            raise ValueError(
                f"plan has {plan.n_units} units but profile has "
                f"{len(profile)} layers")
        self.profile = profile
        self.cluster = cluster
        self.n_channels = max(1, n_channels)
        self.clock = 0.0
        self.iteration = 0
        self._deferred: list[ScenarioEvent] = []
        self.trace = Trace(H=plan.H)
        self.set_plan(plan)
        self.trace.meta.update({
            "n_units": plan.n_units,
            "n_workers": cluster.n_active,
            "n_datacenters": cluster.network.topology.n_datacenters,
        })

    def set_plan(self, plan: SyncPlan) -> None:
        """Swap the schedule (only safe at a period boundary).

        Phase counting restarts at the current iteration, so a plan with
        a different ``H`` stays phase-aligned (``Trace.H`` keeps the
        original period length for period bookkeeping, though — prefer
        swaps that preserve ``H``, as ``Session.simulate`` does).
        """
        if plan.n_units != len(self.profile):
            raise ValueError("new plan's unit count does not match profile")
        self.plan = plan
        self._phase_origin = self.iteration
        n = plan.n_units
        # per phase: BP positions to synchronize (0 = output-most layer)
        self._positions = [sorted(n - 1 - u for u in units)
                           for units in plan.phase_units]

    @property
    def positions_per_phase(self) -> list[list[int]]:
        """Current plan's synchronized BP positions, one list per phase."""
        return [list(p) for p in self._positions]

    # ------------------------------------------------------------------ run
    def run(self, periods: int = 1, *,
            on_events: OnEvents | None = None) -> Trace:
        """Simulate ``periods`` further periods of the current plan.

        Scenario events fire at iteration boundaries; at each *period*
        boundary the events fired there — plus any that fired mid-period
        since the last boundary — are offered to ``on_events``, whose
        returned plan (if any) replaces the schedule for the following
        periods.
        """
        for _ in range(periods):
            new = self.cluster.advance(self.iteration, self.clock)
            if new:
                self.trace.events.extend(self.cluster.log[-len(new):])
            fired, self._deferred = self._deferred + new, []
            if fired and on_events is not None:
                new_plan = on_events(self, fired)
                if new_plan is not None:
                    self.set_plan(new_plan)
            self._run_iteration()                      # phase 0
            for _ in range(1, self.plan.H):
                new = self.cluster.advance(self.iteration, self.clock)
                if new:
                    self.trace.events.extend(self.cluster.log[-len(new):])
                    self._deferred.extend(new)         # replan next boundary
                self._run_iteration()
        return self.trace

    def _run_iteration(self) -> None:
        r, tr = self.iteration, self.trace
        h = self.plan.phase_of_iteration(r - self._phase_origin)
        prof = self.profile
        bp = prof.bp_order()
        n = len(bp)
        t0 = self.clock

        stall = self.cluster.take_stall()
        if stall > 0.0:
            tr.intervals.append(Interval("stall", r, h, -1, t0, t0 + stall))
            t0 += stall

        slow = self.cluster.compute_slowdown()
        fp_end = t0 + prof.t_fp_total * slow
        tr.intervals.append(Interval("fp", r, h, -1, t0, fp_end))

        bp_done = []
        acc = fp_end
        for i, c in enumerate(bp):
            start, acc = acc, acc + c.t_bp * slow
            bp_done.append(acc)
            tr.intervals.append(Interval("bp", r, h, n - 1 - i, start, acc))

        free = [fp_end] * self.n_channels
        comm_end = fp_end
        for i in self._positions[h]:
            ch = min(range(len(free)), key=free.__getitem__)
            start = max(bp_done[i], free[ch])
            unit = n - 1 - i
            dur = self.cluster.collective_time(
                prof.layers[unit].param_bytes, start)
            done = start + dur
            free[ch] = done
            comm_end = max(comm_end, done)
            tr.intervals.append(Interval("comm", r, h, unit, start, done))

        end = max(bp_done[-1] if bp_done else fp_end, comm_end)
        tr.iteration_spans.append((self.clock, end))
        self.clock = end
        self.iteration += 1
