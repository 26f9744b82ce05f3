"""Public wrapper of the flash-attention kernel: CUDA on the card, the
plain version on the CPU.

``impl=None`` launches the CUDA kernel for CUDA tensors and runs
:func:`attention_ref` for CPU tensors; ``impl="ref"`` runs the plain
version explicitly; ``impl="cuda"`` insists on the kernel and raises for
anything it does not take.  There is no fallback from the kernel to the
plain version.  ``flash_attention.launches`` counts kernel launches.

Both dtypes pack the g query heads of a KV head into one block's rows,
at every width in ``HEAD_DIMS``.  bfloat16 runs both products on the
tensor cores (mma.sync bf16); float32 runs Q K^T in exact float32 FMA
on the CUDA cores and P V on the tensor cores in 3xTF32.
"""

from __future__ import annotations

import ctypes

import torch

from ...device import sm_count
from .. import _build
from .._cost import KernelCost, causal_pairs, plain_scope, report
from .ref import attention_ref

__all__ = ["flash_attention", "flash_cost", "HEAD_DIMS"]

HEAD_DIMS = (8, 16, 32, 64, 128, 256)   # head widths the kernel is built for
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_fns: dict[torch.dtype, ctypes._CFuncPtr] = {}


def _fn(dtype: torch.dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(_build.library("flash_attention"),
                     f"flash_attention_fwd_{_SUFFIX[dtype]}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: int | None) -> None:
    if not q.is_cuda:
        raise ValueError("flash_attention impl='cuda' needs CUDA tensors")
    if q.dtype not in _SUFFIX:
        raise TypeError(f"flash_attention kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must match q's device and dtype")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want [b, s, heads, hd] with "
                         "k == v")
    b, _, n_q, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or n_q % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch, head width or GQA grouping")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if window is not None and (window < 1 or not causal
                               or k.shape[1] < q.shape[1]):
        raise ValueError(f"window {window} needs window >= 1, causal=True "
                         "and sk >= sq (every row sees its own key)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def flash_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True, window: int | None = None
               ) -> KernelCost:
    """One launch's work: Q K^T and P V over the (query, key) pairs it
    computes, q, k and v read once and the output written once."""
    b, sq, n_q, hd = q.shape
    flops = 4.0 * b * n_q * hd * causal_pairs(sq, k.shape[1], causal,
                                              window)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return KernelCost("flash_attention", flops, flops, nbytes)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None,
                    impl: str | None = None) -> torch.Tensor:
    """Blockwise GQA attention forward, queries and keys from position 0.

    q ``[b, sq, n_q, hd]``, k/v ``[b, sk, n_kv, hd]`` -> ``[b, sq, n_q,
    hd]`` in q's dtype.  ``causal`` masks ``k_pos > q_pos``; ``window``
    keeps only ``k_pos > q_pos - window`` (a local window).  On ``meta``
    tensors it reports :func:`flash_cost` and returns an empty output.
    """
    if impl is None and q.is_meta:
        report(flash_cost(q, k, v, causal=causal, window=window))
        return torch.empty_like(q)
    if impl is None:
        impl = "cuda" if q.is_cuda else "ref"
    if impl == "ref":
        with plain_scope("flash_attention"):
            return attention_ref(q, k, v, causal=causal, window=window,
                                 scale=scale)
    if impl != "cuda":
        raise ValueError(f"unknown flash_attention impl {impl!r}")
    _check(q, k, v, causal, window)
    b, sq, n_q, hd = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    scale = (hd ** -0.5) if scale is None else scale
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):       # the attribute and the launch
        err = _fn(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), b, sq, sk, n_q, n_kv, hd,
                           int(causal), -1 if window is None else int(window),
                           sm_count(q.device), scale, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
