"""Built-in :class:`SyncStrategy` implementations.

Copy of ``repro.api.strategies``: every name the JAX registry has.

A strategy owns the three decisions the old stringly-typed dispatch spread
across ``core/plans.py`` and ``runtime/step.py``:

1. **plan construction** — :meth:`SyncStrategy.build_plan` turns a
   :class:`~repro_torch.core.profiler.LayerProfile` into a
   :class:`~repro_torch.core.plans.SyncPlan`;
2. **communication mode** — ``comm`` (gradients vs. parameters), recorded
   on the plan so the runtime never inspects algorithm names;
3. **sync hook** — :meth:`SyncStrategy.sync_policy` picks the
   :class:`~repro_torch.core.sync_policies.SyncPolicy` applied at each phase
   (plain mean / int8+EF / outer optimizer).

The paper's algorithms (ssgd, wfbp, ascwfbp, flsgd, plsgd-enp, dreamddp,
dreamddp-bf) are registered here, plus two beyond-string compositions that
prove the registry is a real extension point:

* ``dreamddp-int8`` — the DreamDDP schedule with int8+error-feedback
  compressed syncs (FusionLLM-style adaptive compression, arXiv
  2410.12707);
* ``hier-2tier`` — a HALoS-inspired hierarchical two-tier schedule (arXiv
  2506.04531): the output-most "hot" tier synchronizes every phase (those
  layers accumulate gradient drift fastest and are cheap to ship early in
  BP order), while the remaining "cold" tier is balanced across the period
  like PLSGD-ENP.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from ..core.bubble_fill import fill_bubbles
from ..core.plans import (GRADIENTS, PARAMETERS, SyncPlan,
                          plan_from_partition)
from ..core.profiler import LayerProfile
from ..core.schedule import (brute_force_schedule, dreamddp_schedule,
                             enp_schedule)
from ..core.sync_policies import Int8EFSync, SyncPolicy, resolve_policy
from .registry import register_strategy

__all__ = ["SyncStrategy", "GradientSync", "FLSGD", "PLSGDEqualNumber",
           "DreamDDP", "DreamDDPInt8", "HierarchicalTwoTier", "HierAsync"]


class SyncStrategy:
    """One synchronization algorithm (subclass or duck-type this).

    Subclasses must implement :meth:`build_plan`; ``comm`` defaults to
    parameter synchronization and :meth:`sync_policy` to the StepConfig
    resolution (plain mean unless the config asks for int8/outer).
    """

    name: str = ""
    comm: str = PARAMETERS

    def build_plan(self, profile: LayerProfile, H: int, *,
                   fill_mode: str = "exact") -> SyncPlan:
        raise NotImplementedError

    def sync_policy(self, cfg: Any) -> SyncPolicy:
        """The sync hook for this strategy given a StepConfig."""
        return resolve_policy(cfg)

    def describe(self) -> str:
        return (self.__doc__ or "").strip().splitlines()[0] if self.__doc__ \
            else self.name


@dataclass(frozen=True)
class GradientSync(SyncStrategy):
    """Classic DDP: gradients worker-averaged every iteration (H == 1).

    ``ssgd`` / ``wfbp`` / ``ascwfbp`` share this SPMD execution and differ
    only in the simulated time model (overlap / channel count).
    """

    name: str = "ssgd"
    comm = GRADIENTS

    def build_plan(self, profile, H, *, fill_mode="exact"):
        n = len(profile)
        return SyncPlan(algo=self.name, comm=GRADIENTS, H=1, n_units=n,
                        phase_units=(tuple(range(n)),), fill_units=((),),
                        unit_names=tuple(c.name for c in profile.layers),
                        meta={"bandwidth": profile.hw.bandwidth,
                              "n_workers": profile.hw.n_workers})


@register_strategy("flsgd")
@dataclass(frozen=True)
class FLSGD(SyncStrategy):
    """Full local SGD: all parameters averaged in the period's last phase."""

    name: str = "flsgd"

    def build_plan(self, profile, H, *, fill_mode="exact"):
        n = len(profile)
        phases = tuple(() for _ in range(H - 1)) + (tuple(range(n)),)
        return SyncPlan(algo=self.name, comm=PARAMETERS, H=H, n_units=n,
                        phase_units=phases,
                        fill_units=tuple(() for _ in range(H)),
                        unit_names=tuple(c.name for c in profile.layers),
                        meta={"bandwidth": profile.hw.bandwidth,
                              "n_workers": profile.hw.n_workers})


@register_strategy("plsgd-enp")
@dataclass(frozen=True)
class PLSGDEqualNumber(SyncStrategy):
    """Partial local SGD with equal-number partitioning (ENP baseline)."""

    name: str = "plsgd-enp"

    def build_plan(self, profile, H, *, fill_mode="exact"):
        return plan_from_partition(self.name, profile, H,
                                   enp_schedule(profile, H), None)


@dataclass(frozen=True)
class DreamDDP(SyncStrategy):
    """DreamDDP: Algorithm-2 partition search + §3.4 bubble fills."""

    name: str = "dreamddp"
    scheduler: Callable = dreamddp_schedule

    def build_plan(self, profile, H, *, fill_mode="exact"):
        res = self.scheduler(profile, H)
        fills = fill_bubbles(profile, res.partition, mode=fill_mode)
        return plan_from_partition(self.name, profile, H, res, fills)


@register_strategy("dreamddp-int8")
@dataclass(frozen=True)
class DreamDDPInt8(DreamDDP):
    """DreamDDP schedule composed with int8+EF compressed syncs."""

    name: str = "dreamddp-int8"

    def sync_policy(self, cfg):
        return Int8EFSync()


@register_strategy("hier-async")
@dataclass(frozen=True)
class HierAsync(DreamDDP):
    """DreamDDP schedule on the async two-tier runtime (no barriers).

    The plan's per-phase unit groups become the push granularity of the
    reference's ``repro.hier.AsyncHierRunner``: workers run whole periods
    locally and stream layer-wise deltas to the server tier, which
    merges them with staleness-aware momentum.  The plan is pure data and
    builds here; training with ``async_runtime`` raises in the port's
    :class:`~repro_torch.api.session.Session` until the async runtime is
    ported (ROADMAP.md queue A item 10).
    """

    name: str = "hier-async"
    async_runtime: bool = True


@register_strategy("hier-2tier")
@dataclass(frozen=True)
class HierarchicalTwoTier(SyncStrategy):
    """HALoS-style two-tier schedule: hot tier every phase, cold tier 1/H.

    The output-most ``hot_fraction`` of units (largest per-step drift,
    earliest available in BP order) are synchronized in **every** phase;
    the remaining units are split into H balanced contiguous chunks, one
    per phase.  Every unit still syncs at least once per period, so
    Lemma 4's bounded-staleness argument applies with ``H_l <= H``.
    """

    name: str = "hier-2tier"
    hot_fraction: float = 0.25

    def build_plan(self, profile, H, *, fill_mode="exact"):
        n = len(profile)
        n_hot = max(1, round(n * self.hot_fraction)) if H > 1 else 0
        hot = tuple(range(n - n_hot, n))
        cold = list(range(n - n_hot))
        phase_units, fill_units = [], []
        for h in range(H):
            lo = (len(cold) * h) // H
            hi = (len(cold) * (h + 1)) // H
            phase_units.append(tuple(sorted(set(cold[lo:hi]) | set(hot))))
            # hot repeats beyond their first appearance are supplementary
            fill_units.append(hot if h > 0 else ())
        return SyncPlan(
            algo=self.name, comm=PARAMETERS, H=H, n_units=n,
            phase_units=tuple(phase_units), fill_units=tuple(fill_units),
            unit_names=tuple(c.name for c in profile.layers),
            meta={"hot_units": list(hot),
                  "extra_syncs": (H - 1) * len(hot),
                  "partition_counts": [len(u) for u in phase_units],
                  "bandwidth": profile.hw.bandwidth,
                  "n_workers": profile.hw.n_workers})


# Parameterized instances (same class, different name/config):
register_strategy("ssgd", GradientSync("ssgd"))
register_strategy("wfbp", GradientSync("wfbp"))
register_strategy("ascwfbp", GradientSync("ascwfbp"))
register_strategy("dreamddp", DreamDDP())
# brute-force reference schedule (paper Fig. 15)
register_strategy("dreamddp-bf",
                  DreamDDP(name="dreamddp-bf",
                           scheduler=brute_force_schedule))
