"""Composable synchronization policies — the *sync hook* of a strategy.

Counterpart of ``repro.core.sync_policies``.  A :class:`SyncPolicy`
decides **how** the layer units scheduled for a phase are reconciled
across workers, independently of **which** units the
:class:`~repro_torch.core.plans.SyncPlan` schedules:

* :class:`MeanSync` — plain float32 parameter averaging (paper Eq. 5);
* :class:`Int8EFSync` — int8 quantization with error feedback over the
  worker axis (beyond-paper); its wire format runs through the int8 CUDA
  kernels on the card;
* :class:`OuterOptSync` — DiLoCo-style outer Nesterov step on the averaged
  delta (beyond-paper, see :mod:`repro_torch.core.outer_opt`).

Policies carry their auxiliary state through the two optional
``TrainState`` slots (``ef`` for compression residuals, ``outer`` for the
outer optimizer): :meth:`SyncPolicy.init_state` returns the ``(ef,
outer)`` pair and :meth:`SyncPolicy.apply` threads it through each sync.
Every ``apply`` updates params and aux state **in place** and returns
them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import torch

from ..tree import tree_map
from .outer_opt import OuterConfig, OuterState, outer_init, outer_sync_units
from .partial_sync import UnitLayout, sync_units, tree_unit_map

__all__ = ["SyncPolicy", "MeanSync", "Int8EFSync", "OuterOptSync",
           "resolve_policy", "tree_unit_map"]

Tree = Any


@dataclass(frozen=True)
class SyncPolicy:
    """Base policy: plain worker-mean of the scheduled units (Eq. 5)."""

    name = "mean"

    def init_state(self, params: Tree) -> tuple[Tree | None,
                                                OuterState | None]:
        """Auxiliary ``(ef, outer)`` state for a worker-stacked tree."""
        return None, None

    def apply(self, params: Tree, ef: Tree | None,
              outer: OuterState | None, unit_ids: Sequence[int],
              layout: UnitLayout
              ) -> tuple[Tree, Tree | None, OuterState | None]:
        """Synchronize ``unit_ids``; returns updated (params, ef, outer)."""
        return sync_units(params, unit_ids, layout), ef, outer


@dataclass(frozen=True)
class MeanSync(SyncPolicy):
    """Alias of the base policy, for explicit registration/config."""


@dataclass(frozen=True)
class Int8EFSync(SyncPolicy):
    """int8 + error-feedback compressed partial sync (worker axis)."""

    name = "int8_ef"

    def init_state(self, params: Tree):
        ef = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                            device=x.device), params)
        return ef, None

    def apply(self, params, ef, outer, unit_ids, layout):
        from ..parallel.compression import compressed_worker_mean
        tree_unit_map(compressed_worker_mean, (params, ef), unit_ids, layout,
                      axis=1)
        return params, ef, outer


@dataclass(frozen=True)
class OuterOptSync(SyncPolicy):
    """DiLoCo-style outer optimizer applied to each phase's synced units."""

    name = "outer"
    cfg: OuterConfig = field(default_factory=OuterConfig)

    def init_state(self, params: Tree):
        return None, outer_init(params)

    def apply(self, params, ef, outer, unit_ids, layout):
        new_p, new_o = outer_sync_units(params, outer, unit_ids, layout,
                                        self.cfg)
        return new_p, ef, new_o


def resolve_policy(cfg: Any) -> SyncPolicy:
    """Resolve the policy from a ``StepConfig``.

    ``cfg.policy`` (an explicit :class:`SyncPolicy`, e.g. chosen by a
    :class:`~repro_torch.api.SyncStrategy`) wins; otherwise the legacy
    ``compress`` / ``outer`` flags map onto the equivalent policy.
    """
    policy = getattr(cfg, "policy", None)
    if policy is not None:
        return policy
    if getattr(cfg, "outer", False):
        return OuterOptSync(cfg=getattr(cfg, "outer_cfg", OuterConfig()))
    if getattr(cfg, "compress", None) == "int8_ef":
        return Int8EFSync()
    return MeanSync()
