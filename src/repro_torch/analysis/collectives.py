"""Collective traffic of a cell, reckoned from its specs and its plan
(``repro.analysis.hlo`` counterpart).

The reference parses every collective out of the compiled SPMD module.
The port has no partitioner and no HLO: until multi-GPU training takes
its counts from real process groups (ROADMAP A12), each collective a
sharded program needs is reckoned from the cell's sharding specs, its
sync plan and its activation shapes, and recorded as a
:class:`CollectiveOp` with its kind, per-device result bytes and group
size (a declared departure, ROADMAP C5):

* the DreamDDP partial sync (:func:`partial_sync_ops`): one all-reduce
  per synced leaf and contiguous unit range of the dominant phase over
  the worker axes, of the per-device shard, in float32 (the worker mean
  is taken in float32); a gradient-averaging plan all-reduces every
  leaf's gradient instead (:func:`grad_sync_ops`);
* tensor parallel over ``model`` (:func:`tp_ops`): per layer and
  microbatch, two all-reduces of the activation forward and two
  backward;
* FSDP (:func:`fsdp_ops`): per layer and microbatch, each weight shard
  sharded over the FSDP axis all-gathered forward and again backward,
  and its gradient reduce-scattered;
* two-axis expert parallel (:func:`moe_a2a_ops`): per MoE layer and
  microbatch, the tokens' dispatch and combine all-to-alls forward and
  backward.

Per-device wire bytes follow the reference's ring factors:

    all-reduce       2 (K-1)/K * bytes          (result == operand)
    all-gather         (K-1)/K * result_bytes   (each device receives K-1 shards)
    reduce-scatter     (K-1)/K * operand_bytes  (= (K-1) * result_bytes)
    all-to-all         (K-1)/K * bytes
    collective-permute            bytes
"""

from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass, field

import torch

from ..core.partial_sync import contiguous_ranges
from ..parallel.sharding import axis_size, shard_shape
from ..tree import tree_leaves

__all__ = ["CollectiveOp", "CollectiveSummary", "partial_sync_ops",
           "grad_sync_ops", "tp_ops", "fsdp_ops", "moe_a2a_ops"]


@dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int
    # the reference's flag for f32 all-reduces of bf16 dot partial sums
    # (a CPU-backend artifact of its HLO); never set here
    f32_dot_partial: bool = False

    @property
    def wire_bytes(self) -> float:
        """Per-device bytes on the interconnect (ring model)."""
        k, b = max(self.group_size, 1), float(self.result_bytes)
        if self.kind == "collective-permute":
            return b            # point-to-point: no replica_groups
        if k == 1:
            return 0.0
        if self.kind == "all-reduce":
            return 2.0 * (k - 1) / k * b
        if self.kind == "all-gather":
            return (k - 1) / k * b
        if self.kind == "reduce-scatter":
            return (k - 1) * b                  # operand = K * result
        if self.kind == "all-to-all":
            return (k - 1) / k * b
        return b                                # collective-permute


@dataclass
class CollectiveSummary:
    ops: list[CollectiveOp] = field(default_factory=list)

    @property
    def total_wire_bytes(self) -> float:
        return sum(o.wire_bytes for o in self.ops)

    @property
    def total_wire_bytes_tpu(self) -> float:
        """The reference's bf16-adjusted total (equal here: no op is an
        f32 dot partial)."""
        return sum(o.wire_bytes * (0.5 if o.f32_dot_partial else 1.0)
                   for o in self.ops)

    def by_kind(self) -> dict[str, dict]:
        agg: dict[str, dict] = defaultdict(
            lambda: {"count": 0, "result_bytes": 0, "wire_bytes": 0.0})
        for o in self.ops:
            a = agg[o.kind]
            a["count"] += 1
            a["result_bytes"] += o.result_bytes
            a["wire_bytes"] += o.wire_bytes
        return dict(agg)

    def to_dict(self) -> dict:
        return {"total_wire_bytes": self.total_wire_bytes,
                "total_wire_bytes_tpu": self.total_wire_bytes_tpu,
                "by_kind": self.by_kind(), "n_ops": len(self.ops)}

    def add(self, kind: str, result_bytes: int, group_size: int,
            count: int = 1) -> None:
        """``count`` equal ops; none when the group is one device."""
        if group_size > 1 and result_bytes > 0:
            self.ops += [CollectiveOp(kind, int(result_bytes), group_size)
                         for _ in range(count)]


def _layer_bytes(t: torch.Tensor, spec: tuple, mesh, *, stacked: bool,
                 lead: bool, dtype_bytes: int | None = None) -> int:
    """Per-device bytes of one layer of leaf ``t`` (all of it when not
    ``stacked``); ``lead``: ``t`` has a worker dim first (one worker's
    share is counted).  The layer dim follows the worker dim and is
    never sharded."""
    shape = list(shard_shape(t.shape, spec, mesh))
    if lead:
        shape = shape[1:]
    if stacked:
        shape = shape[1:]
    return math.prod(shape) * (dtype_bytes or t.element_size())


def partial_sync_ops(out: CollectiveSummary, params, specs, mesh, layout,
                     units, group: int) -> None:
    """The phase's parameter sync: for each synced group, one all-reduce
    per leaf and contiguous range of its synced layers (the slices
    ``sync_units`` averages), of the worker-stacked ``params`` under
    ``specs``, in float32."""
    for name, idxs in layout.by_group(units).items():
        leaves = zip(tree_leaves(params[name]), tree_leaves(specs[name]),
                     strict=True)
        for t, spec in leaves:
            if idxs == [None]:
                out.add("all-reduce", _layer_bytes(
                    t, spec, mesh, stacked=False, lead=True, dtype_bytes=4),
                    group)
                continue
            per_layer = _layer_bytes(t, spec, mesh, stacked=True, lead=True,
                                     dtype_bytes=4)
            for lo, hi in contiguous_ranges(idxs):
                out.add("all-reduce", per_layer * (hi - lo), group)


def grad_sync_ops(out: CollectiveSummary, params, specs, mesh,
                  group: int, *, dtype_bytes: int | None = 4) -> None:
    """Every leaf's gradient all-reduced over ``group`` devices each step:
    over the workers by a gradient-averaging plan (the mean in float32),
    or inside a worker whose devices are data-parallel ranks
    (``dtype_bytes=None``: in the parameter dtype)."""
    for t, spec in zip(tree_leaves(params), tree_leaves(specs), strict=True):
        out.add("all-reduce", _layer_bytes(
            t, spec, mesh, stacked=False, lead=True,
            dtype_bytes=dtype_bytes), group)


def tp_ops(out: CollectiveSummary, *, n_layers: int, n_micro: int,
           act_bytes: int, group: int, backward: bool) -> None:
    """Megatron tensor parallel: two activation all-reduces a layer
    forward (after attention and after the MLP), two more backward."""
    per_layer = 4 if backward else 2
    out.add("all-reduce", act_bytes, group,
            count=n_layers * n_micro * per_layer)


def fsdp_ops(out: CollectiveSummary, params, specs, logical, mesh,
             axis: str, *, n_micro: int, backward: bool, lead: bool
             ) -> None:
    """ZeRO-3 over ``axis``: each leaf with a dim sharded over ``axis``
    alone is all-gathered layer by layer before its use, forward and
    again backward, and (training) its gradient reduce-scattered back to
    the shards, every microbatch.  A dim sharded over several axes
    together (two-axis expert parallel) stays local.  ``logical``: the
    model's ``param_specs()`` (a ``layers`` first axis marks a stacked
    leaf)."""
    k = mesh.shape[axis]
    passes = 2 if backward else 1
    for t, spec, names in zip(tree_leaves(params), tree_leaves(specs),
                              tree_leaves(logical), strict=True):
        if axis not in spec:
            continue
        stacked = bool(names) and names[0] == "layers"
        n = t.shape[1 if lead else 0] if stacked else 1
        shard = _layer_bytes(t, spec, mesh, stacked=stacked, lead=lead)
        out.add("all-gather", shard * k, k, count=n * n_micro * passes)
        if backward:
            out.add("reduce-scatter", shard, k, count=n * n_micro)


def moe_a2a_ops(out: CollectiveSummary, *, n_moe_layers: int, n_micro: int,
                token_bytes: int, group: int, backward: bool) -> None:
    """Expert parallel across ``group`` devices: each MoE layer sends its
    routed tokens to their experts and back (two all-to-alls), twice
    more backward."""
    out.add("all-to-all", token_bytes, group,
            count=n_moe_layers * n_micro * (4 if backward else 2))


def group_size(mesh, axes: tuple[str, ...]) -> int:
    """Devices along ``axes`` together (1 for none)."""
    return axis_size(mesh, axes) if axes else 1
