"""Plain PyTorch version of the flash-attention kernel.

It is :func:`repro_torch.models.layers.gqa_attention` restricted to the
flash contract: queries and keys both start at position 0, the only
masks are causal (``k_pos <= q_pos``), the local window (``k_pos > q_pos
- window``) and the key length.  The CPU path
of the serving prefill runs it; on the card ``chip_smoke.py`` holds the
CUDA kernel against it.
"""

from __future__ import annotations

import torch

from ...models.layers import gqa_attention

__all__ = ["attention_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """q ``[b, sq, n_q, hd]``, k/v ``[b, sk, n_kv, hd]`` -> ``[b, sq,
    n_q, hd]`` in q's dtype."""
    return gqa_attention(q, k, v, causal=causal, window=window, scale=scale,
                         q_chunk=None)
