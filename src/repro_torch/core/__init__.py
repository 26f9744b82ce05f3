"""DreamDDP core of the port: the paper's contribution.

Pipeline: profile layers (:mod:`profiler`) -> model the period time
(:mod:`time_model`, Eq. 7/8) -> search the partition (:mod:`schedule`,
Algorithm 2) -> fill bubbles (:mod:`bubble_fill`, §3.4) -> emit a
:class:`~repro_torch.core.plans.SyncPlan` -> execute partial syncs on
worker-stacked trees (:mod:`partial_sync`, :mod:`sync_policies`),
optionally with an outer optimizer (:mod:`outer_opt`, beyond-paper).

The planner modules are framework-free copies of ``repro.core``'s; the
sync modules are PyTorch.
"""

from .bubble_fill import FillResult, fill_bubbles
from .outer_opt import OuterConfig, OuterState, outer_init, outer_sync_units
from .partial_sync import (UnitEntry, UnitLayout, contiguous_ranges,
                           divergence, sync_units, tree_unit_map,
                           tree_worker_mean, unit_divergence, worker_stack,
                           worker_unstack)
from .plans import (ALGOS, SyncPlan, build_plan, local_plan,
                    plan_from_partition)
from .profiler import (A6000_CLUSTER, GEO_WAN, V5E, HardwareSpec, LayerCost,
                       LayerProfile, analytic_profile, measured_profile,
                       ring_allreduce_time)
from .schedule import (ScheduleResult, SearchStats, brute_force_count,
                       brute_force_schedule, dreamddp_schedule, enp_schedule)
from .sync_policies import (Int8EFSync, MeanSync, OuterOptSync, SyncPolicy,
                            resolve_policy)
from .time_model import (Partition, PhaseTimeline, ascwfbp_iteration_time,
                         flsgd_period_time, objective, phase_objective,
                         simulate_period, simulate_phase, ssgd_iteration_time,
                         wfbp_iteration_time)
