"""Public wrapper of the paged-attention kernel: CUDA on the card, the
plain version on the CPU.

``impl=None`` launches the CUDA kernel for CUDA tensors and runs
:func:`paged_attention_ref` for CPU tensors; ``impl="ref"`` runs the
plain version explicitly; ``impl="cuda"`` insists on the kernel and
raises for anything it does not take.  There is no fallback from the
kernel to the plain version.  ``paged_attention.launches`` counts kernel
launches.

The kernel splits each slot's pages over ``splits`` blocks of ``pps``
pages and merges the partials inside the same launch.  The split is
chosen on the host from the shapes and the SM count alone
(:func:`split_pages`); the wrapper never reads ``kv_len``, so a decode
step makes no host sync here.  The partials' scratch and the arrival
counters (which every launch leaves at zero) are kept per device and
stream, and grown by replacement when a larger launch comes along.  A
caller whose launches must keep their addresses, such as a captured CUDA
graph, makes its own with :func:`launch_scratch` and passes it to every
launch (``scratch=``), so nothing reallocates it underneath the graph.
"""

from __future__ import annotations

import ctypes

import torch

from ...device import sm_count
from .. import _build
from .._cost import KernelCost, plain_scope, report
from ..flash_attention.ops import HEAD_DIMS
from .ref import paged_attention_ref

__all__ = ["paged_attention", "paged_cost", "split_pages", "launch_plan",
           "launch_scratch"]

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_fns: dict[torch.dtype, ctypes._CFuncPtr] = {}
# (device index, stream) -> (partial acc, partial (m, l), counters)
_scratch: dict[tuple[int, int], tuple[torch.Tensor, ...]] = {}


def _fn(dtype: torch.dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(_build.library("paged_attention"),
                     f"paged_attention_fwd_{_SUFFIX[dtype]}")
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


_WAVES = 4        # blocks to fill the SMs this many times over
_MIN_PAGES = 2    # pages a split at least (all of them when fewer)


def split_pages(slots: int, n_kv: int, max_blocks: int,
                sms: int) -> tuple[int, int]:
    """``(splits, pages per split)`` for a grid of ``slots x n_kv x
    splits`` blocks: enough splits that the grid fills ``sms`` SMs
    ``_WAVES`` times, but at least ``_MIN_PAGES`` pages a split.  The
    splits cover ``max_blocks`` exactly: ``splits * pps >= max_blocks``
    and no split lies wholly past it.  Plain integers only: the choice
    reads no tensor."""
    want = max(1, -(-_WAVES * sms // max(1, slots * n_kv)))
    pps = max(min(_MIN_PAGES, max_blocks), max_blocks // want)
    return -(-max_blocks // pps), pps


def _scratch_sizes(slots: int, n_q: int, n_kv: int, hd: int,
                   splits: int) -> tuple[int, int, int]:
    """Elements of (partial acc, partial (m, l), counters) a launch of
    ``splits`` splits needs."""
    return slots * n_q * splits * hd, slots * n_q * splits * 2, slots * n_kv


def _new_scratch(device, n_acc: int, n_ml: int, n_cnt: int
                 ) -> tuple[torch.Tensor, ...]:
    return (torch.empty(n_acc, device=device),
            torch.empty(n_ml, device=device),
            torch.zeros(n_cnt, device=device, dtype=torch.int32))


def launch_scratch(slots: int, n_q: int, n_kv: int, hd: int,
                   max_blocks: int, device: torch.device
                   ) -> tuple[torch.Tensor, ...] | None:
    """Scratch of the caller's own for launches of these shapes on
    ``device`` (``None`` when one split covers the pages and the launch
    needs none).  Launches that share it must run in order on one stream:
    they share the arrival counters."""
    splits, _ = split_pages(slots, n_kv, max_blocks, sm_count(device))
    if splits == 1:
        return None
    return _new_scratch(device, *_scratch_sizes(slots, n_q, n_kv, hd,
                                                splits))


def _scratch_for(device: torch.device, stream: int, n_acc: int, n_ml: int,
                 n_cnt: int) -> tuple[torch.Tensor, ...]:
    """Scratch for the split partials and the arrival counters, grown on
    demand.  The counters start at zero and every launch leaves them so;
    launches on one stream run in order, so they share one set."""
    key = (device.index, stream)
    have = _scratch.get(key)
    if have is not None and have[0].numel() >= n_acc \
            and have[1].numel() >= n_ml and have[2].numel() >= n_cnt:
        return have
    if have is not None:
        n_acc, n_ml, n_cnt = (max(n, t.numel())
                              for n, t in zip((n_acc, n_ml, n_cnt), have))
    have = _new_scratch(device, n_acc, n_ml, n_cnt)
    _scratch[key] = have
    return have


def launch_plan(q: torch.Tensor, k_pages: torch.Tensor,
                block_tables: torch.Tensor) -> tuple[int, int]:
    """``(splits, pages per split)`` of a launch, from the shapes and the
    card's SM count: no tensor's data is read."""
    return split_pages(q.shape[0], k_pages.shape[2], block_tables.shape[1],
                       sm_count(q.device))


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
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("kv_len", kv_len)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_cost(q: torch.Tensor, k_pages: torch.Tensor,
               block_tables: torch.Tensor, *, window: int | None = None,
               tokens: int | None = None) -> KernelCost:
    """One launch's work over ``tokens`` attended keys (all slots): Q K^T
    and P V, q in and out, the K and V those keys need, the block tables
    and ``kv_len``.  ``tokens=None`` counts every slot at its most: all
    ``max_blocks`` pages, or the last ``window`` keys."""
    slots, n_q, hd = q.shape
    _, page_size, n_kv, _ = k_pages.shape
    if tokens is None:
        depth = block_tables.shape[1] * page_size
        tokens = slots * min(depth, window or depth)
    es = q.element_size()
    nbytes = (2 * slots * n_q * hd * es + 2 * tokens * n_kv * hd * es
              + block_tables.numel() * 4 + slots * 4)
    flops = 4.0 * n_q * hd * tokens
    return KernelCost("paged_attention", flops, flops, nbytes)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    kv_len: torch.Tensor, *, window: int | None = None,
                    scale: float | None = None, impl: str | None = None,
                    scratch: tuple[torch.Tensor, ...] | None = None
                    ) -> torch.Tensor:
    """Single-token decode attention through per-slot block tables.

    q ``[slots, n_q, hd]``; k/v pages ``[n_pages, page_size, n_kv, hd]``;
    ``block_tables [slots, max_blocks]`` int32 page ids; ``kv_len
    [slots]`` int32 — positions ``< kv_len[b]`` are attended (the query
    sits at ``kv_len[b] - 1``; ``window`` keeps the last ``window`` of
    them).  Returns ``[slots, n_q, hd]`` in q's dtype.  ``scratch``, from
    :func:`launch_scratch` for these shapes, replaces the per-stream
    scratch (the plain version needs none).  On ``meta`` tensors it
    reports :func:`paged_cost` and returns an empty output.
    """
    if impl is None and q.is_meta:
        report(paged_cost(q, k_pages, block_tables, window=window))
        return torch.empty_like(q)
    if impl is None:
        impl = "cuda" if q.is_cuda else "ref"
    if impl == "ref":
        with plain_scope("paged_attention"):
            return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                       kv_len, scale=scale, window=window)
    if impl != "cuda":
        raise ValueError(f"unknown paged_attention impl {impl!r}")
    _check(q, k_pages, v_pages, block_tables, kv_len)
    slots, n_q, hd = q.shape
    _, page_size, n_kv, _ = k_pages.shape
    max_blocks = block_tables.shape[1]
    scale = (hd ** -0.5) if scale is None else scale
    splits, pps = launch_plan(q, k_pages, block_tables)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part_acc = part_ml = counters = None
    if splits > 1:
        sizes = _scratch_sizes(slots, n_q, n_kv, hd, splits)
        if scratch is None:
            scratch = _scratch_for(q.device, stream, *sizes)
        elif any(t.device != q.device or t.numel() < n
                 for t, n in zip(scratch, sizes, strict=True)):
            raise ValueError(f"scratch does not hold a launch of {splits} "
                             f"splits on {q.device}: make it with "
                             "launch_scratch for these shapes")
        part_acc, part_ml, counters = scratch
    with torch.cuda.device(q.device):       # the attribute and the launch
        err = _fn(q.dtype)(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            *(None if t is None else t.data_ptr()
              for t in (part_acc, part_ml, counters)),
            slots, n_q, n_kv, hd, page_size, max_blocks, splits, pps,
            -1 if window is None else int(window), scale, stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
