"""The scenario library — named, seeded geo-cluster regimes.

A :class:`Scenario` is pure data (see ``src/repro/sim/README.md`` for the
full schema): a topology, per-link specs and drift traces, and a tuple of
:mod:`~repro_torch.sim.events` that fire at period boundaries.  ``build(H)``
instantiates the mutable :class:`~repro_torch.sim.events.VirtualCluster` for a
run with period length ``H``; identical ``(scenario, H)`` builds replay
identically.

The built-in library covers the regimes the paper and its related work
(FusionLLM's heterogeneous links, HALoS' hierarchical geo-clusters)
evaluate:

==================  =====================================================
``homogeneous``     flat single-DC cluster, static 1 GB/s link
``hier-2tier``      2 datacenters, fast intra / slow+laggy inter links
``drifting-bandwidth``  WAN bandwidth steps down 1 GB/s -> 150 MB/s
``straggler``       one worker computes 2.5x slower for one period
``churn``           2 workers leave, then 2 (new ids) join
``transient-failure``   a worker drops and recovers (whole-DP stall)
``degraded-inter``  inter-DC link degraded to 30% for one period
==================  =====================================================

Run the library's conformance sweep from the CLI (the ``make sim``
target)::

    PYTHONPATH=src python -m repro_torch.sim [--algo dreamddp] [-H 4]

Framework-free copy of ``repro.sim.scenarios`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .events import (BandwidthDrift, LinkDegradation, ScenarioEvent,
                     StragglerOnset, TransientFailure, VirtualCluster,
                     WorkerJoin, WorkerLeave)
from .network import DriftTrace, LinkSpec, NetworkModel, Topology

__all__ = ["Scenario", "register_scenario", "get_scenario",
           "available_scenarios", "SCENARIOS"]


@dataclass(frozen=True)
class Scenario:
    """Declarative description of one simulated geo-cluster regime."""

    name: str
    description: str
    n_workers: int = 8
    n_datacenters: int = 1
    intra: LinkSpec = LinkSpec(bandwidth=1e9, latency=1e-4)
    inter: LinkSpec | None = None
    drift: dict[str, DriftTrace] = field(default_factory=dict)
    events: tuple[ScenarioEvent, ...] = ()
    periods: int = 3
    seed: int = 0

    def topology(self) -> Topology:
        return Topology(self.n_workers, self.n_datacenters)

    def build(self, H: int) -> VirtualCluster:
        """Instantiate the mutable cluster for a run with period ``H``."""
        net = NetworkModel(self.topology(), self.intra, self.inter,
                           drift=dict(self.drift))
        return VirtualCluster(net, self.events, H=H, seed=self.seed)


# ---------------------------------------------------------------- registry

SCENARIOS: dict[str, Scenario] = {}


def register_scenario(sc: Scenario) -> Scenario:
    if sc.name in SCENARIOS:
        raise ValueError(f"scenario {sc.name!r} already registered")
    SCENARIOS[sc.name] = sc
    return sc


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; available: "
                       f"{available_scenarios()}") from None


def available_scenarios() -> tuple[str, ...]:
    return tuple(sorted(SCENARIOS))


# ------------------------------------------------------------ the library

register_scenario(Scenario(
    name="homogeneous",
    description="Flat single-DC cluster on a static 1 GB/s link; the "
                "executor must reproduce time_model exactly.",
    n_workers=8, periods=2,
))

register_scenario(Scenario(
    name="hier-2tier",
    description="Two datacenters (HALoS regime): 20 GB/s intra links, "
                "200 MB/s / 5 ms inter-DC WAN; hierarchical all-reduce.",
    n_workers=8, n_datacenters=2,
    intra=LinkSpec(bandwidth=2e10, latency=5e-5),
    inter=LinkSpec(bandwidth=2e8, latency=5e-3),
    periods=2,
))

register_scenario(Scenario(
    name="drifting-bandwidth",
    description="WAN bandwidth steps 1 GB/s -> 150 MB/s at period 1 "
                "(piecewise-constant drift); replanning should move "
                "comm off the critical path again.",
    n_workers=8,
    events=(BandwidthDrift(period=1, link="intra", bandwidth=1.5e8),),
    periods=3,
))

register_scenario(Scenario(
    name="straggler",
    description="Worker 3 computes 2.5x slower during period 1 only "
                "(thermal throttling / noisy neighbour); fast 20 GB/s "
                "link so the cluster is compute-bound and the straggler "
                "gates the critical path.",
    n_workers=8,
    intra=LinkSpec(bandwidth=2e10, latency=5e-5),
    events=(StragglerOnset(period=1, worker=3, slowdown=2.5,
                           duration_periods=1),),
    periods=3,
))

register_scenario(Scenario(
    name="churn",
    description="Elastic membership: 2 workers leave at period 1, 2 new "
                "workers join at period 2 (ring size changes twice).",
    n_workers=8,
    events=(WorkerLeave(period=1, n=2), WorkerJoin(period=2, n=2)),
    periods=3,
))

register_scenario(Scenario(
    name="transient-failure",
    description="Worker 0 fails at period 1 and recovers after 50 ms; "
                "synchronous DP stalls the whole iteration.",
    n_workers=8,
    events=(TransientFailure(period=1, worker=0, downtime=0.05),),
    periods=3,
))

register_scenario(Scenario(
    name="degraded-inter",
    description="Two-tier cluster whose inter-DC link degrades to 30% "
                "bandwidth for one period, then recovers.",
    n_workers=8, n_datacenters=2,
    intra=LinkSpec(bandwidth=2e10, latency=5e-5),
    inter=LinkSpec(bandwidth=5e8, latency=2e-3),
    events=(LinkDegradation(period=1, link="inter", factor=0.3,
                            duration_periods=1),),
    periods=3,
))


# ----------------------------------------------------------------- CLI

def main(argv=None) -> int:
    """Conformance-sweep the whole library (the ``make sim`` target)."""
    import argparse

    from .conformance import check_library

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--algo", action="append", default=None,
                    help="strategy to check (repeatable); default: "
                         "dreamddp, plsgd-enp, flsgd")
    ap.add_argument("-H", "--period", type=int, default=4)
    args = ap.parse_args(argv)
    algos = tuple(args.algo) if args.algo else ("dreamddp", "plsgd-enp",
                                                "flsgd")
    reports = check_library(algos=algos, H=args.period)
    for r in reports:
        print(r.summary())
    bad = [r for r in reports if not r.ok]
    print(f"{len(reports) - len(bad)}/{len(reports)} conformance "
          f"checks passed")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
