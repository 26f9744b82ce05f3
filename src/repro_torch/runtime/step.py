"""Serve-side step functions (the serve half of ``repro.runtime.step``).

The reference builds jitted closures (``make_slot_prefill_step`` and
friends) and vmaps single-lane steps over the slot axis.  PyTorch runs
eagerly, so these are plain functions, and the model's own steps already
take a write position per lane.  Cache leaves are ``[layers, lanes,
...]``; a slot is one lane of axis 1.
"""

from __future__ import annotations

from typing import Any

import torch

__all__ = ["slot_prefill", "slot_decode", "slot_decode_paged"]

Tree = Any


def slot_prefill(model, params, tokens: torch.Tensor, depth: int,
                 refeed: tuple[torch.Tensor, torch.Tensor] | None = None
                 ) -> tuple[torch.Tensor, Tree]:
    """Prefill K same-length requests into K fresh cache lanes.

    ``tokens [K, S]`` (one row per request, all padded to one bucket
    length; K = 1 is the serial path); the lanes are ``depth >= S``
    deep and every lane writes from position 0, the model's native
    prefill contract.  With ``refeed = (tok [K], pos [K])`` the last
    prompt token of each lane is decoded again at its own position —
    after a right-padded prefill the last logits belong to a pad, and
    this recovers the true ones (it rewrites the identical KV entry and
    attends the same causal window).  Returns (logits ``[K, V]``, lanes)
    for the caller to commit into its pool.
    """
    lanes = model.init_cache(tokens.shape[0], depth, device=tokens.device)
    logits, lanes = model.prefill(params, tokens, lanes)
    if refeed is not None:
        tok, pos = refeed
        logits, lanes = model.decode_step(params, lanes, tok[:, None], pos)
    return logits[:, 0], lanes


def slot_decode(model, params, arena: Tree, tokens: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """One decode tick over every lane of a contiguous arena, each lane
    at its own position (``tokens [S]``, ``pos [S]``) -> logits ``[S,
    V]``.  The arena is updated in place."""
    logits, _ = model.decode_step(params, arena, tokens[:, None], pos)
    return logits[:, 0]


def slot_decode_paged(model, params, pages: Tree, tokens: torch.Tensor,
                      pos: torch.Tensor, block_tables: torch.Tensor,
                      active: torch.Tensor) -> torch.Tensor:
    """One decode tick against the paged pool: ``block_tables [S,
    max_blocks]`` route the KV traffic and ``active [S]`` parks inactive
    lanes' writes on the trash page.  -> logits ``[S, V]``; the pool is
    updated in place."""
    logits, _ = model.decode_step_paged(params, pages, tokens[:, None], pos,
                                        block_tables, active)
    return logits[:, 0]
