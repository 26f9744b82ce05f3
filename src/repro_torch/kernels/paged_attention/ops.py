"""Public wrapper of the paged-attention kernel: CUDA on the card, the
plain version on the CPU.

``impl=None`` launches the CUDA kernel for CUDA tensors and runs
:func:`paged_attention_ref` for CPU tensors; ``impl="ref"`` runs the
plain version explicitly; ``impl="cuda"`` insists on the kernel and
raises for anything it does not take.  There is no fallback from the
kernel to the plain version.  ``paged_attention.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import paged_attention_ref

__all__ = ["paged_attention"]

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_fns: dict[torch.dtype, ctypes._CFuncPtr] = {}


def _fn(dtype: torch.dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(_build.library("paged_attention"),
                     f"paged_attention_fwd_{_SUFFIX[dtype]}")
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def _check(q, k_pages, v_pages, block_tables, kv_len) -> None:
    if not q.is_cuda:
        raise ValueError("paged_attention impl='cuda' needs CUDA tensors")
    if q.dtype not in _SUFFIX:
        raise TypeError(f"paged_attention kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must match q's device and dtype")
    for name, t in (("block_tables", block_tables), ("kv_len", kv_len)):
        if t.device != q.device or t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 on q's device")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}: "
                         "want q [slots, n_q, hd] and equal k/v pages "
                         "[n_pages, page_size, n_kv, hd]")
    slots, n_q, hd = q.shape
    if k_pages.shape[3] != hd or n_q % k_pages.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and pages "
                         f"{tuple(k_pages.shape)} disagree on head width "
                         "or GQA grouping")
    if block_tables.dim() != 2 or block_tables.shape[0] != slots \
            or tuple(kv_len.shape) != (slots,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"kv_len {tuple(kv_len.shape)} do not match "
                         f"{slots} slots")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("kv_len", kv_len)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    kv_len: torch.Tensor, *, window: int | None = None,
                    scale: float | None = None,
                    impl: str | None = None) -> torch.Tensor:
    """Single-token decode attention through per-slot block tables.

    q ``[slots, n_q, hd]``; k/v pages ``[n_pages, page_size, n_kv, hd]``;
    ``block_tables [slots, max_blocks]`` int32 page ids; ``kv_len
    [slots]`` int32 — positions ``< kv_len[b]`` are attended (the query
    sits at ``kv_len[b] - 1``; ``window`` keeps the last ``window`` of
    them).  Returns ``[slots, n_q, hd]`` in q's dtype.
    """
    if impl is None:
        impl = "cuda" if q.is_cuda else "ref"
    if impl == "ref":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   kv_len, scale=scale, window=window)
    if impl != "cuda":
        raise ValueError(f"unknown paged_attention impl {impl!r}")
    _check(q, k_pages, v_pages, block_tables, kv_len)
    slots, n_q, hd = q.shape
    _, page_size, n_kv, _ = k_pages.shape
    scale = (hd ** -0.5) if scale is None else scale
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn(q.dtype)(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                       block_tables.data_ptr(), kv_len.data_ptr(),
                       out.data_ptr(), slots, n_q, n_kv, hd, page_size,
                       block_tables.shape[1],
                       -1 if window is None else int(window), scale, stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
