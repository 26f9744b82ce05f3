"""Plain PyTorch version of the SSD chunk kernel.

The contract of ``repro.kernels.ssd_scan`` (its ``ref.py`` and the
Pallas kernel): per ``(batch, chunk, head)`` cell, in float32,

    cum   = cumsum(da)
    L     = tril(exp(cum_i - cum_j))          (selected, never multiplied)
    y     = ((C B^T) * L) X                   in x's dtype
    state = X^T (B * exp(cum_last - cum))     float32

The CPU path of the Mamba-2 prefill runs it; on the card
``chip_smoke.py`` holds the CUDA kernel against it.
"""

from __future__ import annotations

import torch

__all__ = ["ssd_chunk_ref"]


def ssd_chunk_ref(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  da: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, NC, H, cs, p]``; b/c ``[B, NC, H, cs, n]``; da ``[B, NC, H,
    cs]`` -> (y ``[B, NC, H, cs, p]`` in x's dtype, states ``[B, NC, H,
    p, n]`` float32)."""
    xf, bf, cf = x.float(), b.float(), c.float()
    cum = torch.cumsum(da.float(), dim=-1)                  # [B,NC,H,cs]
    seg = cum[..., :, None] - cum[..., None, :]
    cs = x.shape[3]
    tril = torch.ones(cs, cs, dtype=torch.bool, device=x.device).tril()
    # above the diagonal exp(seg) may be inf: select, never multiply
    L = torch.where(tril, torch.exp(seg), 0.0)
    y = ((cf @ bf.transpose(-1, -2)) * L) @ xf
    decay = torch.exp(cum[..., -1:] - cum)                  # [B,NC,H,cs]
    s = xf.transpose(-1, -2) @ (bf * decay[..., None])
    return y.to(x.dtype), s
