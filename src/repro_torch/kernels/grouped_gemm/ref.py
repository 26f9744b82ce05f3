"""Plain PyTorch version of the grouped expert products: one
``torch.mm`` per group over its rows, the CPU path and the oracle the
card's tests hold the kernel to.

``offs [G + 1]`` int32 gives the groups: rows ``[offs[g], offs[g + 1])``
of the row operand belong to group ``g``.  The offsets are read on the
host, so this version does not run inside a CUDA graph capture.
"""

from __future__ import annotations

import torch

__all__ = ["grouped_gemm_ref"]


def grouped_gemm_ref(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor,
                     layout: str) -> torch.Tensor:
    """``fwd``: a = X ``[M, K]``, b = W ``[G, K, N]`` -> Y ``[M, N]``;
    ``dgrad``: a = dY ``[M, N]``, b = W -> dX ``[M, K]``; ``wgrad``: a =
    X ``[M, K]``, b = dY ``[M, N]`` -> dW ``[G, K, N]``.  Rows past the
    last group are zeros in fwd and dgrad; an empty group's dW is zeros."""
    bounds = offs.tolist()
    G = len(bounds) - 1
    if layout == "wgrad":
        out = a.new_zeros(G, a.shape[1], b.shape[1])
        for g in range(G):
            lo, hi = bounds[g], bounds[g + 1]
            if hi > lo:
                out[g] = torch.mm(a[lo:hi].t(), b[lo:hi])
        return out
    if layout not in ("fwd", "dgrad"):
        raise ValueError(f"unknown grouped_gemm layout {layout!r}")
    width = b.shape[2] if layout == "fwd" else b.shape[1]
    out = a.new_zeros(a.shape[0], width)
    for g in range(G):
        lo, hi = bounds[g], bounds[g + 1]
        if hi > lo:
            w = b[g] if layout == "fwd" else b[g].t()
            out[lo:hi] = torch.mm(a[lo:hi], w)
    return out
