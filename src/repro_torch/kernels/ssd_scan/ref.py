"""Plain PyTorch version of the SSD chunk kernel.

The contract of ``repro.kernels.ssd_scan`` (its ``ref.py`` and the
Pallas kernel): per ``(batch, chunk, head)`` cell, in float32,

    cum   = cumsum(da)
    L     = tril(exp(cum_i - cum_j))          (selected, never multiplied)
    y     = ((C B^T) * L) X                   in x's dtype
    state = X^T (B * exp(cum_last - cum))     float32

:func:`ssd_chunk_grouped_ref` is the same function in the model's
layout (``[B, Lp, H, p]``, b/c ``[B, Lp, G, n]`` with G groups): it
expands the groups to heads, cuts ``Lp`` into chunks and applies
:func:`ssd_chunk_ref`.  The CPU path of the Mamba-2 prefill runs it; on
the card ``chip_smoke.py`` holds the CUDA kernel against both.
"""

from __future__ import annotations

import torch

__all__ = ["ssd_chunk_ref", "ssd_chunk_grouped_ref"]


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


def ssd_chunk_grouped_ref(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                          da: torch.Tensor, chunk: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, Lp, H, p]``; b/c ``[B, Lp, G, n]`` (head h reads group ``h
    // (H // G)``); da ``[B, Lp, H]``; ``Lp`` a multiple of ``chunk`` ->
    (y ``[B, Lp, H, p]`` in x's dtype, states ``[B, Lp // chunk, H, p,
    n]`` float32)."""
    bs, lp, h, p = x.shape
    rep = h // b.shape[2]
    nc = lp // chunk

    def tpu(t):       # [B, Lp, K, d] -> [B, NC, K, cs, d]
        return t.reshape(bs, nc, chunk, *t.shape[2:]).transpose(2, 3)

    y, s = ssd_chunk_ref(tpu(x), tpu(b.repeat_interleave(rep, dim=2)),
                         tpu(c.repeat_interleave(rep, dim=2)),
                         da.reshape(bs, nc, chunk, h).transpose(2, 3))
    return y.transpose(2, 3).reshape(bs, lp, h, p), s
