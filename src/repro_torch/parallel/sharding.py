"""Logical-axis -> mesh sharding rules (``repro.parallel.sharding``
counterpart).

Models annotate every parameter leaf with logical axis names
(``'vocab' | 'heads' | 'ff' | 'expert' | 'layers' | None``,
``model.param_specs()``).  This module turns those into per-leaf specs
for a mesh — a spec is a tuple with one entry per dim: ``None``
(replicated), a mesh-axis name, or a tuple of them (the reference's
``PartitionSpec`` entries):

* tensor/expert parallel: ``vocab/heads/ff/expert -> 'model'``;
* the worker axis (divergent local-SGD replicas) is **prepended** to every
  spec — ``('data',)`` / ``('pod','data')`` for small archs, ``('pod',)``
  for large ones, ``()`` when W == 1;
* FSDP (large archs): the first unsharded non-layer dim of every >=2D leaf
  is sharded over ``'data'`` (ZeRO-3-style storage).

The mesh is anything with a ``shape`` mapping of axis name -> size
(:class:`repro_torch.launch.mesh.MeshSpec`); nothing here needs devices.
:func:`shard_shape` gives a leaf's per-device shape under its spec.
:func:`maybe_constrain` is the identity: the port has no ambient mesh
until multi-GPU training (ROADMAP A12), which wires it into the models.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..tree import tree_map

__all__ = ["RULES", "RULES_FSDP_MODEL", "RULES_EP2", "leaf_spec",
           "param_shardings", "batch_shardings", "named",
           "cache_shardings", "maybe_constrain", "shard_shape",
           "shard_bytes", "axis_size"]

Tree = Any
Spec = tuple


def maybe_constrain(x: torch.Tensor, *dims) -> torch.Tensor:
    """The reference's activation-sharding constraint.  With no ambient
    mesh (the reference's CPU behaviour, and always in the port until
    ROADMAP A12) it is the identity."""
    del dims
    return x


RULES: dict[str | None, str | None] = {
    "vocab": "model",
    "heads": "model",
    "ff": "model",
    "expert": "model",
    "layers": None,
    None: None,
}

RULES_FSDP_MODEL: dict[str | None, str | None] = {
    # intra-worker ZeRO-3: no tensor parallel; weights sharded over the
    # model axis via the fsdp mechanism, batch sharded over `model`.
    # Expert dim keeps EP (weights already partitioned by expert).
    "vocab": None, "heads": None, "ff": None, "expert": "model",
    "layers": None, None: None,
}

RULES_EP2: dict[str | None, object] = {
    # two-axis expert parallel: expert dim over (`data` x `model`) jointly
    # (256 experts / 256 devices = 1 expert a device, weights fully
    # local); non-expert weights TP over `model` + FSDP over `data`.
    "vocab": "model", "heads": "model", "ff": None,
    "expert": ("data", "model"), "layers": None, None: None,
}


def _axes_of(m) -> tuple[str, ...]:
    if m is None:
        return ()
    return (m,) if isinstance(m, str) else tuple(m)


def axis_size(mesh, entry) -> int:
    """Devices a spec entry (None, an axis, or a tuple of axes) spans."""
    return math.prod(mesh.shape[a] for a in _axes_of(entry))


def leaf_spec(logical: tuple, *, worker_axes: tuple[str, ...] = (),
              fsdp: bool = False, fsdp_axis: str = "data",
              with_lead: bool = True, shape: tuple[int, ...] | None = None,
              mesh=None, rules: dict | None = None) -> Spec:
    """One leaf's spec from its logical axes.

    Each mesh axis may appear at most once: the first logical dim claiming
    it wins (e.g. MoE ``('expert', None, 'ff')`` -> expert-parallel over
    ``model``, ``ff`` left unsharded).  ``with_lead`` prepends the worker
    axis entry (worker-stacked training trees); serving trees have no
    worker dim and pass ``with_lead=False``.  With ``shape``/``mesh`` a dim
    is only sharded when divisible by the mesh axis (e.g. vocab 50280 over
    model=16 falls back to replicated)."""
    used = set(worker_axes)
    off = 1 if with_lead else 0
    rules = RULES if rules is None else rules

    def divisible(i: int, m) -> bool:
        if shape is None or mesh is None:
            return True
        return shape[i + off] % axis_size(mesh, m) == 0

    dims: list = []
    for i, ax in enumerate(logical):
        m = rules.get(ax, None)
        if m is not None and (any(a in used for a in _axes_of(m))
                              or not divisible(i, m)):
            m = None
        if m is not None:
            used.update(_axes_of(m))
        dims.append(m)
    if fsdp and fsdp_axis not in used:
        # shard the first unsharded, non-layer dim over `data`
        for i, (ax, d) in enumerate(zip(logical, dims, strict=True)):
            if d is None and ax != "layers" and len(logical) >= 2 \
                    and divisible(i, fsdp_axis):
                dims[i] = fsdp_axis
                break
    if not with_lead:
        return tuple(dims)
    lead = (worker_axes if len(worker_axes) != 1 else worker_axes[0]) \
        if worker_axes else None
    return (lead, *dims)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def param_shardings(spec_tree: Tree, mesh, *,
                    worker_axes: tuple[str, ...] = (),
                    fsdp: bool = False, with_lead: bool = True,
                    shapes: Tree | None = None,
                    rules: dict | None = None,
                    fsdp_axis: str = "data") -> Tree:
    """Specs for a (worker-stacked) parameter tree.

    ``spec_tree`` mirrors the *unstacked* params (logical tuples at
    leaves); with ``with_lead`` the worker axis is assumed prepended to
    every leaf.  ``shapes`` (a matching tree of tensors, ``meta`` ones
    will do) enables the divisibility checks."""
    def one(sp, t=None):
        return leaf_spec(tuple(sp), worker_axes=worker_axes, fsdp=fsdp,
                         with_lead=with_lead,
                         shape=None if t is None else tuple(t.shape),
                         mesh=mesh, rules=rules, fsdp_axis=fsdp_axis)

    if shapes is None:
        return tree_map(one, spec_tree)
    return tree_map(one, spec_tree, shapes)


def named(mesh, *dims) -> Spec:
    """A spec from explicit entries, checked against ``mesh``'s axes."""
    for d in dims:
        for a in _axes_of(d):
            if a not in mesh.shape:
                raise ValueError(f"axis {a!r} not in mesh {mesh.shape}")
    return tuple(dims)


def batch_shardings(batch_spec: Tree, mesh, *,
                    worker_axes: tuple[str, ...],
                    data_axes_left: tuple[str, ...]) -> Tree:
    """Training batch ``[W, B/W, ...]``: worker axis + leftover data axes."""
    lead = (worker_axes if len(worker_axes) != 1 else worker_axes[0]) \
        if worker_axes else None
    sub = (data_axes_left if len(data_axes_left) != 1 else
           data_axes_left[0]) if data_axes_left else None
    return tree_map(lambda s: named(mesh, lead, sub,
                                    *(None,) * (s.dim() - 2)), batch_spec)


def cache_shardings(cache_spec: Tree, mesh, *,
                    batch_axes=("data",)) -> Tree:
    """Serving caches ``[n_layers, B, S, ...]``: shard batch over data, and
    the head/state trailing dims over 'model' when present (>=4D leaves)."""
    ba = batch_axes if len(batch_axes) != 1 else batch_axes[0]

    def one(s):
        nd = s.dim()
        if nd >= 4:
            # [layers, B, S, heads, ...] -> heads over model
            return named(mesh, None, ba, None, "model", *(None,) * (nd - 4))
        if nd == 3:
            return named(mesh, None, ba, None)
        return (None,) * nd

    return tree_map(one, cache_spec)


def shard_shape(shape, spec: Spec, mesh) -> tuple[int, ...]:
    """A leaf's per-device shape: each dim divided (rounded up, as an
    uneven shard is padded) by the devices its spec entry spans; a spec
    shorter than the shape leaves the rest whole."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-int(n) // axis_size(mesh, e))
                 for n, e in zip(shape, spec))


def shard_bytes(t: torch.Tensor, spec: Spec, mesh) -> int:
    """Bytes of ``t``'s shard on one device."""
    return math.prod(shard_shape(t.shape, spec, mesh)) * t.element_size()
