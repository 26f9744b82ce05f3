"""Public wrappers of the grouped expert products: CUDA on the card, the
plain version on the CPU.

:func:`grouped_gemm` is one launch of one layout (``fwd``, ``dgrad``,
``wgrad``; :mod:`.ref` says what each computes).  :func:`grouped_mm` is
the differentiable product ``Y = X W[g]`` over groups, a
``torch.autograd.Function`` whose backward launches dgrad for ``X`` and
wgrad for ``W``; the offsets take no gradient.

``impl=None`` launches the CUDA kernel for CUDA tensors and runs the
plain version for CPU tensors; ``impl="ref"`` runs the plain version
explicitly; ``impl="cuda"`` insists on the kernel and raises for
anything it does not take (float32 operands among them: the kernel is
bf16 with float32 accumulation).  There is no fallback from a kernel to
its plain version.  On ``meta`` tensors a call reports its work to the
cost counter at its most (every row in a group) and launches nothing.

``grouped_gemm.launches`` counts kernel launches and
``.launches_by_shape`` counts them by ``(layout, K, N)`` of the weight
``[G, K, N]``: a launch of any layout over ``rows`` routed rows does
``2 rows K N`` operations.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from .. import _build
from .._cost import KernelCost, plain_scope, report
from .ref import grouped_gemm_ref

__all__ = ["LAYOUTS", "grouped_gemm", "grouped_mm", "grouped_cost"]

LAYOUTS = ("fwd", "dgrad", "wgrad")
_fn_cache: list = []


def _fn():
    if not _fn_cache:
        lib = _build.library("grouped_gemm")
        fn = lib.grouped_gemm_bf16
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_cache.append(fn)
    return _fn_cache[0]


def _shapes(a, b, offs, layout):
    """(M, G, K, N, output shape) of one call; raises on a mismatch."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown grouped_gemm layout {layout!r}")
    if offs.dim() != 1 or a.dim() != 2:
        raise ValueError(f"grouped_gemm takes rows [M, *] and offsets "
                         f"[G + 1], got {tuple(a.shape)}, {tuple(offs.shape)}")
    G = offs.shape[0] - 1
    M = a.shape[0]
    if layout == "wgrad":
        K, N = a.shape[1], b.shape[1]
        if b.dim() != 2 or b.shape[0] != M:
            raise ValueError(f"grouped_gemm wgrad: X {tuple(a.shape)} and "
                             f"dY {tuple(b.shape)} need the same rows")
        return M, G, K, N, (G, K, N)
    if b.dim() != 3 or b.shape[0] != G:
        raise ValueError(f"grouped_gemm {layout}: W {tuple(b.shape)} is not "
                         f"[G={G}, K, N]")
    K, N = b.shape[1], b.shape[2]
    if a.shape[1] != (K if layout == "fwd" else N):
        raise ValueError(f"grouped_gemm {layout}: rows {tuple(a.shape)} "
                         f"against W {tuple(b.shape)}")
    return M, G, K, N, (M, N if layout == "fwd" else K)


def grouped_cost(rows: int, G: int, K: int, N: int, es: int = 2
                 ) -> KernelCost:
    """One launch of any layout over ``rows`` grouped rows: ``2 rows K N``
    operations; the ``G`` weights (fwd, dgrad) or their gradients (wgrad)
    moved once, and rows of ``K`` and of ``N`` read or written once."""
    flops = 2.0 * rows * K * N
    return KernelCost("grouped_gemm", flops, flops,
                      (G * K * N + rows * (K + N)) * es)


def grouped_gemm(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor,
                 layout: str, *, impl: str | None = None) -> torch.Tensor:
    """One grouped product of ``layout`` (see :mod:`.ref`)."""
    M, G, K, N, out_shape = _shapes(a, b, offs, layout)
    if impl is None and a.is_meta:
        report(grouped_cost(M, G, K, N, a.element_size()))
        return torch.empty(out_shape, dtype=a.dtype, device="meta")
    if impl is None:
        impl = "cuda" if a.is_cuda else "ref"
    if impl not in ("ref", "cuda"):
        raise ValueError(f"unknown grouped_gemm impl {impl!r}")
    if impl == "ref":
        with plain_scope("grouped_gemm"):
            return grouped_gemm_ref(a, b, offs, layout)
    if not (a.is_cuda and b.device == a.device and offs.device == a.device):
        raise ValueError("grouped_gemm impl='cuda' takes its operands and "
                         "offsets on one CUDA device")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 \
            or offs.dtype != torch.int32:
        raise TypeError(f"grouped_gemm kernel takes bf16 operands and int32 "
                        f"offsets, got {a.dtype}, {b.dtype}, {offs.dtype}")
    if K % 8 or N % 8:
        raise ValueError(f"grouped_gemm kernel needs K and N multiples of "
                         f"8, got {K}, {N}")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty(out_shape, dtype=a.dtype, device=a.device)
    if any(t.data_ptr() % 16 for t in (a, b, out)):
        raise ValueError("grouped_gemm kernel needs 16-byte aligned operands")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _fn()(LAYOUTS.index(layout), a.data_ptr(), b.data_ptr(),
                    out.data_ptr(), offs.data_ptr(), G, M, K, N, stream)
    if err:
        raise RuntimeError(f"grouped_gemm {layout} launch failed: CUDA "
                           f"error {err}")
    grouped_gemm.launches += 1
    grouped_gemm.launches_by_shape[(layout, K, N)] += 1
    return out


grouped_gemm.launches = 0
grouped_gemm.launches_by_shape = collections.Counter()


class _GroupedMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, offs, impl):
        ctx.save_for_backward(x, w, offs)
        ctx.impl = impl
        return grouped_gemm(x, w, offs, "fwd", impl=impl)

    @staticmethod
    def backward(ctx, dy):
        x, w, offs = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = grouped_gemm(dy, w, offs, "dgrad", impl=ctx.impl)
        if ctx.needs_input_grad[1]:
            dw = grouped_gemm(x, dy, offs, "wgrad", impl=ctx.impl)
        return dx, dw, None, None


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor, *,
               impl: str | None = None) -> torch.Tensor:
    """``Y [M, N]``: row ``r`` of group ``g`` is ``X[r] W[g]`` (``X [M,
    K]``, ``W [G, K, N]``, ``offs [G + 1]`` int32); rows past the last
    group are zeros.  Differentiable in ``X`` and ``W``."""
    return _GroupedMM.apply(x, w, offs, impl)
