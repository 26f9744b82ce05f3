"""LocalServer / GlobalServer — the two-tier async state machine.

Counterpart of ``repro.hier.servers`` in torch math on the device.

The :class:`GlobalServer` holds the float32 reference model (unstacked:
no worker axis, layer-stacked groups keep their layer axis at position
0) plus the merge rule's auxiliary state (momentum; delta buffer for
delayed-Nesterov) and a monotonically increasing ``version`` counter —
one increment per merge.  Staleness of a delta is
``version_at_merge - version_at_pull``.

A :class:`LocalServer` fronts one datacenter: workers push per-phase
layer-group deltas to it without blocking, it accumulates them, and
every ``pushes_per_merge`` arrivals it forwards the batch (averaged at
merge time) upstream.  With the default of 1 it is a pass-through tier;
with more it trades staleness for fewer inter-DC transfers.

Both tiers are driven strictly by the deterministic op log of
:class:`repro_torch.hier.executor.AsyncSimExecutor` — they never consult
a wall clock or ambient randomness, which is what makes
checkpoint/restart replay to an identical trace.

Differences from the reference:

* merges update ``params``, ``momentum`` and ``buffer`` **in place**,
  over the merged units' slices (:func:`~repro_torch.core.partial_sync.
  tree_unit_map`), with whole-tensor ops and no host read.  So the tree
  :meth:`GlobalServer.snapshot` returns moves with every later merge: a
  caller that holds it as a delta base must clone it (the runner does,
  at each pull);
* the delayed-Nesterov flush multiplies the buffer by ``1 / dn_delay``
  where the reference divides by ``dn_delay``: XLA computes that
  division as the same product, and PyTorch on CUDA would too (a
  division by a Python scalar), so every backend rounds alike.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from ..core.partial_sync import UnitLayout, tree_unit_map
from ..lint import hot_path
from ..tree import tree_map
from .merge import MergeConfig, staleness_scale

__all__ = ["GlobalServer", "LocalServer", "PushEntry"]

Tree = Any


class GlobalServer:
    """Global tier: staleness-aware merges into the reference model."""

    def __init__(self, params: Tree, layout: UnitLayout,
                 cfg: MergeConfig, *, n_workers: int):
        self.cfg = cfg.resolve(n_workers)
        self.layout = layout
        self.params = tree_map(
            lambda x: x.detach().to(torch.float32, copy=True), params)
        self.momentum = tree_map(torch.zeros_like, self.params)
        self.buffer = tree_map(torch.zeros_like, self.params)
        self.version = 0
        self.dn_count = 0
        self.staleness_hist: dict[int, int] = {}

    # -------------------------------------------------------------- merges
    # hot path: one call per MergeOp; device work only, no host read
    @hot_path
    def merge(self, delta: Tree, base_version: int,
              unit_ids: Sequence[int]) -> int:
        """Fold one (averaged) delta into the model, in place; returns
        its staleness.

        ``delta`` is unstacked float32 (same structure as ``params``);
        only the slices belonging to ``unit_ids`` are touched, and
        ``delta`` is left as it is.
        """
        tau = max(0, self.version - base_version)
        scale = staleness_scale(self.cfg, tau)
        cfg, units = self.cfg, tuple(unit_ids)
        if cfg.rule == "halos":
            def step(w, m, d):
                ds = d * scale
                m.mul_(cfg.momentum).add_(ds)
                upd = ds.add_(m * cfg.momentum) if cfg.nesterov else m
                w.add_(upd * cfg.lr)
                return None, None, None
            tree_unit_map(step, (self.params, self.momentum, delta), units,
                          self.layout)
        else:
            def step(w, b, d):
                ds = d * scale
                b.add_(ds)
                w.add_(ds.mul_(cfg.lr))
                return None, None, None
            tree_unit_map(step, (self.params, self.buffer, delta), units,
                          self.layout)
            self.dn_count += 1
            if self.dn_count >= cfg.dn_delay:
                self._flush()
                self.dn_count = 0
        self.version += 1
        self.staleness_hist[tau] = self.staleness_hist.get(tau, 0) + 1
        return tau

    def _flush(self) -> None:
        """Delayed-Nesterov: fold the buffered average into the momentum
        and apply it in one step (every leaf, in place)."""
        cfg = self.cfg
        inv = 1.0 / cfg.dn_delay

        def one(w, m, b):
            m.mul_(cfg.momentum).add_(b.mul_(inv))
            b.zero_()
            w.add_(cfg.lr * cfg.momentum * m)

        tree_map(one, self.params, self.momentum, self.buffer)

    # --------------------------------------------------------------- state
    def snapshot(self) -> tuple[Tree, int]:
        """Current ``(params, version)`` — what a pulling worker sees.

        The returned tree is the server's own, updated in place by every
        later merge: clone it to hold it as a delta base.
        """
        return self.params, self.version

    def state(self) -> dict:
        """Array state for checkpointing (scalars live in :meth:`meta`)."""
        return {"params": self.params, "momentum": self.momentum,
                "buffer": self.buffer}

    def meta(self) -> dict:
        return {"version": self.version, "dn_count": self.dn_count,
                "staleness_hist": {str(k): v for k, v in
                                   sorted(self.staleness_hist.items())}}

    def load(self, state: dict, meta: dict) -> None:
        def as32(tree, like):
            return tree_map(lambda x, y: x.to(y.device, torch.float32),
                            tree, like)
        self.params = as32(state["params"], self.params)
        self.momentum = as32(state["momentum"], self.momentum)
        self.buffer = as32(state["buffer"], self.buffer)
        self.version = int(meta["version"])
        self.dn_count = int(meta["dn_count"])
        self.staleness_hist = {int(k): int(v) for k, v in
                               meta["staleness_hist"].items()}


class PushEntry:
    """One worker push waiting (or in flight) at a local server."""

    __slots__ = ("worker", "period", "phase", "units", "base_version",
                 "delta")

    def __init__(self, worker, period, phase, units, base_version, delta):
        self.worker = worker
        self.period = period
        self.phase = phase
        self.units = tuple(sorted(units))
        self.base_version = base_version
        self.delta = delta

    @property
    def key(self) -> tuple[int, int, int]:
        return (self.worker, self.period, self.phase)

    def describe(self) -> dict:
        return {"worker": self.worker, "period": self.period,
                "phase": self.phase, "units": list(self.units),
                "base_version": self.base_version}


class LocalServer:
    """Local tier: per-datacenter accumulation of worker pushes."""

    def __init__(self, dc: int):
        self.dc = dc
        self.entries: list[PushEntry] = []

    def push(self, delta: Tree, units: Sequence[int], base_version: int,
             *, worker: int, period: int, phase: int) -> None:
        self.entries.append(PushEntry(worker, period, phase, units,
                                      base_version, delta))

    def take(self, contributors: Sequence[tuple[int, int, int]]
             ) -> list[PushEntry]:
        """Pop the entries named by the executor's merge op, in op order."""
        want = list(contributors)
        by_key = {e.key: e for e in self.entries}
        missing = [k for k in want if tuple(k) not in by_key]
        if missing:
            raise KeyError(f"local server {self.dc} missing pushes "
                           f"{missing}")
        taken = [by_key[tuple(k)] for k in want]
        drop = {tuple(k) for k in want}
        self.entries = [e for e in self.entries if e.key not in drop]
        return taken

    @staticmethod
    def merged_delta(entries: Sequence[PushEntry]
                     ) -> tuple[Tree, tuple[int, ...], int]:
        """Average a flush batch: ``(delta, union units, min base)``.  A
        batch of one passes its delta through; a larger one is a new
        tree, summed in entry order and scaled by ``1 / len`` as the
        reference does."""
        deltas = [e.delta for e in entries]
        if len(deltas) == 1:
            avg = deltas[0]
        else:
            inv = 1.0 / len(deltas)
            avg = tree_map(lambda *xs: sum(xs[1:], xs[0]) * inv, *deltas)
        units: set[int] = set()
        for e in entries:
            units.update(e.units)
        base = min(e.base_version for e in entries)
        return avg, tuple(sorted(units)), base

    def describe(self) -> list[dict]:
        return [e.describe() for e in self.entries]
