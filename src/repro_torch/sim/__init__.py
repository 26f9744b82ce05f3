"""repro_torch.sim — deterministic geo-cluster simulator (SimNet).

Drives the real :class:`~repro_torch.core.plans.SyncPlan` machinery against a
virtual network instead of a live mesh, so heterogeneous inter-DC links,
bandwidth drift, stragglers and worker churn become CI-runnable tests
and benchmarks:

* :mod:`~repro_torch.sim.network` — links, piecewise-constant drift, 2-tier
  (intra-DC / inter-DC) topology;
* :mod:`~repro_torch.sim.events` — scenario events + the seeded
  :class:`VirtualCluster` replaying them;
* :mod:`~repro_torch.sim.executor` — :class:`SimExecutor` replays a plan's
  phase timeline, producing a :class:`~repro_torch.sim.trace.Trace`;
* :mod:`~repro_torch.sim.scenarios` — the named scenario library;
* :mod:`~repro_torch.sim.conformance` — checks the simulator against
  :mod:`repro_torch.core.time_model` on every static window.

Quick start::

    from repro_torch.api import JobConfig, Session
    report = Session(JobConfig(algo="dreamddp", period=4)).simulate(
        "drifting-bandwidth")
    print(report.summary())

See the reference's ``src/repro/sim/README.md`` for the scenario schema.

Framework-free copy of ``repro.sim`` (the port imports
nothing of the JAX package).
"""

from .conformance import (ConformanceReport, WindowCheck, check_library,
                          check_scenario, reference_period_time,
                          synthetic_profile)
from .events import (REPLAN_EVENTS, BandwidthDrift, LinkDegradation,
                     ScenarioEvent, StragglerOnset, TransientFailure,
                     VirtualCluster, WorkerJoin, WorkerLeave)
from .executor import SimExecutor, SimReport, prepare_run
from .network import DriftTrace, LinkSpec, NetworkModel, Topology
from .scenarios import (SCENARIOS, Scenario, available_scenarios,
                        get_scenario, register_scenario)
from .trace import Interval, Trace

__all__ = [
    "LinkSpec", "DriftTrace", "Topology", "NetworkModel",
    "ScenarioEvent", "StragglerOnset", "LinkDegradation", "BandwidthDrift",
    "WorkerJoin", "WorkerLeave", "TransientFailure", "VirtualCluster",
    "REPLAN_EVENTS",
    "SimExecutor", "SimReport", "prepare_run", "Interval", "Trace",
    "Scenario", "SCENARIOS", "register_scenario", "get_scenario",
    "available_scenarios",
    "ConformanceReport", "WindowCheck", "check_scenario", "check_library",
    "reference_period_time", "synthetic_profile",
]
