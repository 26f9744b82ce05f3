"""Carry parameter trees across frameworks as nested dicts of numpy arrays.

The JAX package's parameters (``jax.device_get(model.init(key))``) are a
nested dict of numpy arrays; the port's are the same dict of tensors,
same keys, same shapes (block groups stacked ``[n_layers, ...]``).
numpy has no bfloat16 of its own, so bfloat16 leaves travel as float32,
which holds every bfloat16 value exactly.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["params_from_numpy", "params_to_numpy"]

Tree = Any


def _leaf_from_numpy(a, device, dtype):
    a = np.asarray(a)
    bf16 = a.dtype.name == "bfloat16"     # ml_dtypes' bfloat16 from JAX
    # a copy: JAX hands out read-only buffers, tensors must own theirs
    t = torch.from_numpy(np.array(a, np.float32 if bf16 else a.dtype))
    target = dtype or (torch.bfloat16 if bf16 else t.dtype)
    return t.to(device=device, dtype=target)


def params_from_numpy(tree: Tree, device, dtype: torch.dtype | None = None
                      ) -> Tree:
    """Nested dict of numpy arrays -> the same dict of tensors on
    ``device``.  ``dtype`` casts every leaf; by default each leaf keeps
    its own type (bfloat16 included)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    return _leaf_from_numpy(tree, device, dtype)


def params_to_numpy(tree: Tree) -> Tree:
    """Dict of tensors -> nested dict of numpy arrays on the host
    (bfloat16 leaves come back as float32, exactly)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
