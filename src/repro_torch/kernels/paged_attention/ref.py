"""Plain PyTorch version of the paged-attention kernel, and the two page
helpers every paged cache write and read goes through.

Mirrors ``repro.kernels.paged_attention.ref`` op for op: gather the
slot's pages into its logical stream, then the same float32 scores,
``-1e30`` mask fill and float32 softmax cast to the activation dtype as
:func:`repro_torch.models.layers.gqa_attention`.  The CPU tests and
``chip_smoke.py`` hold the CUDA kernel against it; on a CUDA tensor the
serving path never calls it.  :func:`paged_attention_split_ref` spells
out the kernel's split-K over pages and its merge, for the tests.
"""

from __future__ import annotations

import torch

__all__ = ["write_token_to_pages", "gather_pages", "paged_attention_ref",
           "paged_attention_split_ref"]

TRASH_PAGE = 0


def write_token_to_pages(pages: torch.Tensor, block_tables: torch.Tensor,
                         pos: torch.Tensor, active: torch.Tensor,
                         values: torch.Tensor) -> torch.Tensor:
    """Write one token's cache entry per slot into the page pool, in place.

    pages ``[n_pages, page_size, ...]``; ``block_tables [slots,
    max_blocks]``; ``pos [slots]`` logical write position; ``values
    [slots, ...]``.  Inactive lanes write to the trash page (page 0),
    so a retired slot's stale block table cannot corrupt pages that
    were handed to a new tenant.  The write is unconditional; several
    inactive lanes may hit page 0 at once, which is harmless because
    page 0 is never read.  Returns ``pages`` (updated in place, where
    the reference returns a new array).
    """
    page_size = pages.shape[1]
    pos = pos.long()
    blk = block_tables.gather(1, (pos // page_size)[:, None])[:, 0]
    page_ids = torch.where(active, blk, TRASH_PAGE).long()
    pages[page_ids, pos % page_size] = values.to(pages.dtype)
    return pages


def gather_pages(pages: torch.Tensor, block_tables: torch.Tensor
                 ) -> torch.Tensor:
    """Rebuild each slot's logical KV stream from the page pool.

    pages ``[n_pages, page_size, ...]``, block_tables ``[slots,
    max_blocks]`` -> ``[slots, max_blocks * page_size, ...]`` in position
    order (entries past a slot's allocated blocks gather the trash page;
    callers mask them by valid length).
    """
    slots, max_blocks = block_tables.shape
    g = pages[block_tables.long()]               # [slots, mb, ps, ...]
    return g.reshape((slots, max_blocks * pages.shape[1])
                     + tuple(pages.shape[2:]))


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        kv_len: torch.Tensor, *, scale: float | None = None,
                        window: int | None = None) -> torch.Tensor:
    """q ``[slots, n_q, hd]``; k/v pages ``[n_pages, ps, n_kv, hd]``;
    returns ``[slots, n_q, hd]`` (the query sits at ``kv_len - 1``)."""
    slots, n_q, hd = q.shape
    n_kv = k_pages.shape[2]
    scale = (hd ** -0.5) if scale is None else scale

    k = gather_pages(k_pages, block_tables)      # [slots, L, n_kv, hd]
    v = gather_pages(v_pages, block_tables)
    if n_kv != n_q:
        k = k.repeat_interleave(n_q // n_kv, dim=2)
        v = v.repeat_interleave(n_q // n_kv, dim=2)
    sk = k.shape[1]

    qc = q[:, None]                              # [slots, 1, n_q, hd]
    scores = torch.einsum("bqnh,bsnh->bnqs", qc.float(), k.float()) * scale
    qpm = (kv_len.long() - 1)[:, None, None, None]
    kpm = torch.arange(sk, device=q.device)[None, None, None, :]
    mask = kpm <= qpm
    if window is not None:
        mask = mask & (kpm > qpm - window)
    mask = mask & (kpm < kv_len.long()[:, None, None, None])
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bnqs,bsnh->bqnh", probs, v)
    return out[:, 0]


def paged_attention_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              block_tables: torch.Tensor,
                              kv_len: torch.Tensor, *, pages_per_split: int,
                              scale: float | None = None,
                              window: int | None = None) -> torch.Tensor:
    """The CUDA kernel's arithmetic in float32, for the tests: each slot's
    pages in splits of ``pages_per_split``, each split's partial ``(m, l,
    acc)`` over the pages it visits (``[z*pps, (z+1)*pps)`` clipped to
    ``ceil(kv_len/ps)`` pages and, with ``window >= 1``, from the page of
    the window's first key), then ``m = max m_i`` and ``out = sum
    e^(m_i - m) acc_i / max(sum e^(m_i - m) l_i, 1e-30)`` over the splits
    in order.  A slot with no visited page gives 0."""
    slots, n_q, hd = q.shape
    _, ps, n_kv, _ = k_pages.shape
    max_blocks = block_tables.shape[1]
    g = n_q // n_kv
    scale = (hd ** -0.5) if scale is None else scale
    pps = pages_per_split
    out = torch.zeros(slots, n_q, hd)
    for b in range(slots):
        n = int(kv_len[b])
        n_pages = min(-(-n // ps), max_blocks) if n > 0 else 0
        first = max(0, n - window) // ps if window and window >= 1 else 0
        parts = []
        for z in range(-(-max_blocks // pps)):
            lo, hi = max(z * pps, first), min(z * pps + pps, n_pages)
            if hi <= lo:
                continue
            pages = block_tables[b, lo:hi].long()
            k = k_pages[pages].float().reshape(-1, n_kv, hd)
            v = v_pages[pages].float().reshape(-1, n_kv, hd)
            k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
            pos = torch.arange(lo * ps, hi * ps)
            ok = pos < n
            if window is not None:
                ok &= pos > n - 1 - window
            s = torch.einsum("nh,knh->nk", q[b].float(), k) * scale
            s = torch.where(ok[None], s, -1e30)
            m = s.max(1).values
            p = torch.exp(s - m[:, None])
            parts.append((m, p.sum(1), torch.einsum("nk,knh->nh", p, v)))
        if parts:
            m = torch.stack([pm for pm, _, _ in parts]).max(0).values
            num = torch.zeros(n_q, hd)
            den = torch.zeros(n_q)
            for pm, pl, pa in parts:
                w = torch.exp(pm - m)
                num += w[:, None] * pa
                den += w * pl
            out[b] = num / torch.clamp(den, min=1e-30)[:, None]
    return out.to(q.dtype)
