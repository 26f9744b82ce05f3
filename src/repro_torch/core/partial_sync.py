"""Layer-unit indexing over parameter trees + partial synchronization ops.

Counterpart of ``repro.core.partial_sync``.  The runtime stores parameters
with a **leading worker axis**: every leaf of the model tree is stacked to
``[W, ...]`` where ``W`` is the number of local-SGD workers.  On one GPU
the W replicas simply live side by side in device memory.

Model parameter trees are organised into named **groups**:

* plain groups (``embed``, ``head``) — synchronized as one unit;
* stacked groups (``blocks``) — leaves carry a layer axis at position 1
  (``[W, n_layers, ...]``); each layer index is its own schedulable unit,
  and a phase's contiguous layer interval is one slice.

A :class:`UnitLayout` lists the units in **network order** — the same order
the profiler and scheduler use — and maps every unit to (group, index).

The mean is taken in ``float32`` and cast back (bf16 parameter averaging
loses ~3 bits otherwise).  Unlike the reference's pure functions,
:func:`sync_units` writes the synchronized slices **in place**: a
full-width worker-stacked tree is too large to copy per step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import torch

from ..tree import tree_leaves, tree_map

__all__ = [
    "UnitEntry",
    "UnitLayout",
    "contiguous_ranges",
    "sync_units",
    "tree_worker_mean",
    "worker_stack",
    "worker_unstack",
    "divergence",
    "unit_divergence",
    "tree_unit_map",
]

Tree = Any


@dataclass(frozen=True)
class UnitEntry:
    """One schedulable layer unit."""

    name: str
    group: str
    index: int | None = None        # None => whole (plain) group

    @property
    def is_stacked(self) -> bool:
        return self.index is not None


@dataclass(frozen=True)
class UnitLayout:
    """Ordered layer units (network order: unit 0 touches the input)."""

    entries: tuple[UnitEntry, ...]

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(e.name for e in self.entries)

    def by_group(self, unit_ids: Sequence[int]) -> dict[str, list[int | None]]:
        """Group the given unit ids: group -> stacked indices (or [None])."""
        out: dict[str, list[int | None]] = {}
        for u in unit_ids:
            e = self.entries[u]
            out.setdefault(e.group, []).append(e.index)
        return out

    def validate_against(self, params: Tree, *,
                         worker_stacked: bool = True) -> None:
        """Check every referenced group exists and stack sizes match.

        ``worker_stacked=False`` for raw model trees (stack axis 0 instead
        of 1)."""
        axis = 1 if worker_stacked else 0
        for e in self.entries:
            if e.group not in params:
                raise KeyError(f"unit {e.name}: group {e.group!r} missing "
                               f"from params (has {list(params)})")
        for group, idxs in self.by_group(range(len(self))).items():
            real = [i for i in idxs if i is not None]
            if not real:
                continue
            leaves = tree_leaves(params[group])
            if not leaves:
                raise ValueError(f"group {group!r} has no leaves")
            n = leaves[0].shape[axis]
            if max(real) >= n:
                raise ValueError(
                    f"group {group!r}: layout references layer {max(real)} "
                    f"but stack has {n}")


def contiguous_ranges(indices: Sequence[int]) -> list[tuple[int, int]]:
    """Sorted ``[lo, hi)`` runs covering ``indices``."""
    if not indices:
        return []
    xs = sorted(set(indices))
    out, lo, prev = [], xs[0], xs[0]
    for x in xs[1:]:
        if x == prev + 1:
            prev = x
            continue
        out.append((lo, prev + 1))
        lo = prev = x
    out.append((lo, prev + 1))
    return out


# ---------------------------------------------------------------------------
# Worker-axis helpers
# ---------------------------------------------------------------------------

def worker_stack(params: Tree, n_workers: int) -> Tree:
    """Tile a plain param tree to ``[W, ...]`` (identical initial replicas —
    the paper's requirement that workers start from a synchronization
    point).  Each leaf is a real copy, since training updates it in
    place."""
    return tree_map(
        lambda x: x.unsqueeze(0).repeat(n_workers, *([1] * x.dim())),
        params)


def worker_unstack(params: Tree, worker: int = 0) -> Tree:
    """Extract one worker's replica (views, e.g. for evaluation/serving)."""
    return tree_map(lambda x: x[worker], params)


def _mean_bcast(x: torch.Tensor) -> torch.Tensor:
    """Average over the worker axis and broadcast back — the parameter
    all-reduce.  Mean in float32, cast back to the storage dtype."""
    m = x.float().mean(0, keepdim=True).to(x.dtype)
    return m.expand_as(x)


def tree_worker_mean(tree: Tree) -> Tree:
    """Full synchronization: a new tree, every leaf averaged over the
    worker axis (contiguous ``[W, ...]``)."""
    return tree_map(lambda x: _mean_bcast(x).contiguous(), tree)


# ---------------------------------------------------------------------------
# Partial synchronization (the paper's core op)
# ---------------------------------------------------------------------------

def tree_unit_map(fn, trees: Sequence[Tree], unit_ids: Sequence[int],
                  layout: UnitLayout, *, axis: int = 0) -> tuple:
    """Apply ``fn`` to each unit-group slice of N parallel param-like trees
    and write the results back **in place**.

    ``fn(*slices)`` receives one tensor slice per tree and returns the
    same number of updated slices; a ``None`` in place of a slice leaves
    that tree's slice as it is (``fn`` may update it in place).  Plain (unstacked) groups pass whole
    leaves; layer-stacked groups pass contiguous ``[lo:hi)`` slices along
    ``axis`` (0 for unstacked trees, 1 for worker-stacked trees).  Leaves
    outside ``unit_ids`` are untouched.  Returns ``trees``.

    This is the one slicing idiom behind :func:`sync_units`, the int8+EF
    sync and the outer-optimizer sync (the reference returns new trees).
    """
    n = len(trees)
    for group, idxs in layout.by_group(unit_ids).items():
        if idxs == [None]:
            index = [(...,)]
        else:
            if None in idxs:
                raise ValueError(
                    f"group {group!r} mixes plain and stacked units")
            index = [(slice(None),) * axis + (slice(lo, hi),)
                     for lo, hi in contiguous_ranges(idxs)]
        leaves = [tree_leaves(t[group]) for t in trees]
        for xs in zip(*leaves, strict=True):
            for ix in index:
                new = fn(*(x[ix] for x in xs))
                if len(new) != n:
                    raise ValueError(f"fn returned {len(new)} slices for "
                                     f"{n} trees")
                for x, val in zip(xs, new, strict=True):
                    if val is not None:
                        x[ix].copy_(val)
    return tuple(trees)


def sync_units(params: Tree, unit_ids: Sequence[int], layout: UnitLayout
               ) -> Tree:
    """Average the given layer units across workers, **in place**; other
    units are untouched.  Returns ``params``.

    ``params`` is a dict of groups; every leaf is worker-stacked ``[W, ...]``
    (stacked groups ``[W, n_layers, ...]``).
    """
    tree_unit_map(lambda x: (_mean_bcast(x),), (params,), unit_ids, layout,
                  axis=1)
    return params


# ---------------------------------------------------------------------------
# Model divergence Gamma_r (paper Fig. 5 / Lemma 4)
# ---------------------------------------------------------------------------

def divergence(params: Tree) -> torch.Tensor:
    """``Gamma_r = (1/K) sum_k ||w_k - w_bar||^2`` over the worker axis."""
    def leaf_div(x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        d = xf - xf.mean(0, keepdim=True)
        return (d * d).sum() / x.shape[0]
    return sum(leaf_div(x) for x in tree_leaves(params))


def unit_divergence(params: Tree, layout: UnitLayout) -> torch.Tensor:
    """Per-unit divergence vector (network order), for Fig. 5-style plots."""
    vals = []
    for e in layout.entries:
        sub = params[e.group]
        if e.index is not None:
            sub = tree_map(lambda x, i=e.index: x[:, i], sub)
        vals.append(divergence(sub))
    return torch.stack(vals)
