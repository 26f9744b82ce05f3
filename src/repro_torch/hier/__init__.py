"""Asynchronous two-tier (hierarchical) execution runtime (counterpart of
``repro.hier``).

Workers run DreamDDP partial-sync periods locally and push layer-wise
deltas to a local-server tier that merges into a global model with
staleness-aware momentum — no period-boundary barrier.  Timing is
decided by a deterministic event executor on seeded virtual clocks
(:class:`AsyncSimExecutor`); the training math replays its op log
(:class:`AsyncHierRunner`, on the device in torch math).  The
reference's ``src/repro/hier/DESIGN.md`` describes the design; the
runner's module docstring lists where the port differs.
"""

from .conformance import (AsyncConformanceReport, check_async_library,
                          check_async_scenario, reference_async_spans)
from .executor import (AsyncConfig, AsyncSimExecutor, JoinOp, LeaveOp,
                       MergeOp, PeriodOp, PullOp, PushOp)
from .merge import MERGE_RULES, MergeConfig, staleness_scale
from .runner import AsyncHierRunner, AsyncRunnerConfig
from .servers import GlobalServer, LocalServer, PushEntry

__all__ = [
    "AsyncConfig", "AsyncSimExecutor",
    "PullOp", "PeriodOp", "PushOp", "MergeOp", "JoinOp", "LeaveOp",
    "MERGE_RULES", "MergeConfig", "staleness_scale",
    "GlobalServer", "LocalServer", "PushEntry",
    "AsyncHierRunner", "AsyncRunnerConfig",
    "AsyncConformanceReport", "check_async_scenario",
    "check_async_library", "reference_async_spans",
]
