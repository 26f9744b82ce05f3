"""Staleness-aware merge rules for the hierarchical server tier.

Two rules, both operating on the *same per-layer sync units* the
DreamDDP scheduler emits (via
:func:`repro_torch.core.sync_policies.tree_unit_map`), so layer-wise partial
sync composes with asynchronous push/pull:

* ``"halos"`` — HALoS-style staleness-aware momentum (arxiv 2506.04531):
  each arriving delta is scaled by ``staleness_beta ** min(tau, bound)``
  (``tau`` = global versions elapsed since the contributing worker
  pulled), folded into a server-side momentum, and applied with a
  Nesterov-style look-ahead — the same shape as the DiLoCo outer step in
  :mod:`repro_torch.core.outer_opt`, but keyed by staleness instead of a
  synchronous round.

* ``"delayed-nesterov"`` — from "Asynchronous Local-SGD Training for
  Language Modeling" (arxiv 2401.09135): apply the (staleness-scaled)
  delta immediately *without* momentum, accumulate it in a buffer, and
  every ``dn_delay`` merges fold the buffered average into the momentum
  and apply that in one delayed step.  Decouples the momentum update
  rate from the (asynchronous, bursty) delta arrival rate.

The staleness clamp ``max_staleness`` is the async counterpart of the
paper's Lemma 4 bound: a delta can never be weighted as if it were less
than ``staleness_beta ** max_staleness`` stale, and the executor's
histogram records how often the clamp engages.

Framework-free copy of ``repro.hier.merge`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

__all__ = ["MergeConfig", "MERGE_RULES", "staleness_scale"]

PyTree = Any

MERGE_RULES = ("halos", "delayed-nesterov")


@dataclass(frozen=True)
class MergeConfig:
    """Hyper-parameters of the global merge (see module docstring).

    ``lr`` defaults to ``1 / n_workers`` (resolved at server init): each
    worker's full-period delta lands with weight ``1/W``, so a round of
    W fresh deltas advances the global model by the worker-mean delta —
    the async analogue of Eq. 5's synchronous parameter average.
    ``dn_delay`` defaults to ``n_workers`` for the same reason: one
    delayed-momentum application per nominal round.
    """

    rule: str = "halos"
    lr: float | None = None            # None -> 1 / n_workers
    momentum: float = 0.9
    nesterov: bool = True              # halos: Nesterov-style application
    staleness_beta: float = 0.9        # per-version decay of merge weight
    max_staleness: int = 8             # staleness clamp (Lemma 4 analogue)
    dn_delay: int = 0                  # delayed-nesterov: 0 -> n_workers

    def __post_init__(self):
        if self.rule not in MERGE_RULES:
            raise ValueError(f"merge rule must be one of {MERGE_RULES}, "
                             f"got {self.rule!r}")
        if not 0.0 < self.staleness_beta <= 1.0:
            raise ValueError("staleness_beta must be in (0, 1]")
        if self.max_staleness < 0:
            raise ValueError("max_staleness must be >= 0")

    def resolve(self, n_workers: int) -> "MergeConfig":
        """Fill ``lr`` / ``dn_delay`` defaults for a concrete fleet size."""
        out = self
        if out.lr is None:
            out = replace(out, lr=1.0 / max(1, n_workers))
        if out.dn_delay <= 0:
            out = replace(out, dn_delay=max(1, n_workers))
        return out


def staleness_scale(cfg: MergeConfig, tau: int) -> float:
    """Weight of a delta that is ``tau`` global versions stale."""
    return cfg.staleness_beta ** min(max(0, tau), cfg.max_staleness)
