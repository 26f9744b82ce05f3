"""Parameter trees as nested dicts of tensors (the reference's pytrees).

JAX flattens a dict in sorted-key order; :func:`tree_leaves` does the
same, so sums over leaves run in the reference's order.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_map", "tree_leaves"]

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and of the same-shaped ``rest``
    (a leaf is anything that is not a dict)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    """The leaves of ``tree`` in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]
