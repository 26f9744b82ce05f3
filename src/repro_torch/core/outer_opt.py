"""Beyond-paper: DiLoCo-style outer optimization on partial syncs.

Counterpart of ``repro.core.outer_opt``.  The paper averages parameters at
each sync (``w <- mean_k w_k``).  DiLoCo [Douillard et al., 2024] instead
treats the averaged *delta* since the last sync as a pseudo-gradient and
applies an outer Nesterov-momentum step.  DreamDDP's layer-wise decoupling
composes naturally: per-unit outer state, updated only for the units
synchronized in the current phase.

The outer params/momentum are float32 and worker-stacked like the params
(2x the params' elements), so the policy is off by default.  Updates are
written in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Sequence

import torch

from ..tree import tree_map
from .partial_sync import UnitLayout, tree_unit_map

__all__ = ["OuterConfig", "OuterState", "outer_init", "outer_sync_units"]

Tree = Any


class OuterState(NamedTuple):
    """Per-parameter outer-optimizer state (worker-stacked like params,
    but numerically identical across the worker axis)."""

    outer_params: Tree   # the slow/global weights
    momentum: Tree       # Nesterov momentum on pseudo-gradients


@dataclass(frozen=True)
class OuterConfig:
    lr: float = 0.7
    beta: float = 0.9
    nesterov: bool = True


def outer_init(worker_params: Tree) -> OuterState:
    """Outer weights start at the (identical) initial replicas."""
    return OuterState(
        outer_params=tree_map(lambda x: x.float().clone(), worker_params),
        momentum=tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                device=x.device),
                          worker_params),
    )


def _outer_step(outer: torch.Tensor, mom: torch.Tensor, avg: torch.Tensor,
                cfg: OuterConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """One Nesterov step on the pseudo-gradient ``outer - avg``."""
    pseudo_grad = outer - avg.float()
    mom_new = cfg.beta * mom + pseudo_grad
    direction = pseudo_grad + cfg.beta * mom_new if cfg.nesterov else mom_new
    return outer - cfg.lr * direction, mom_new


def outer_sync_units(params: Tree, state: OuterState,
                     unit_ids: Sequence[int], layout: UnitLayout,
                     cfg: OuterConfig = OuterConfig(),
                     ) -> tuple[Tree, OuterState]:
    """Partial sync with outer optimization, in place.

    For each synced unit: workers average (mean) their parameters, the
    outer optimizer consumes the mean as a pseudo-gradient, and every worker
    resets that unit to the new outer weights (a synchronization point, as in
    plain averaging — so Lemma 4's bounded-staleness argument still applies).
    """
    def one(p, o, m):
        avg = p.float().mean(0, keepdim=True)
        o2, m2 = _outer_step(o, m, avg, cfg)
        return o2.to(p.dtype), o2, m2

    tree_unit_map(one, (params, state.outer_params, state.momentum),
                  unit_ids, layout, axis=1)
    return params, state
