"""Public wrappers of the int8 row kernels: CUDA on the card, the plain
versions on the CPU.

``impl=None`` launches the CUDA kernel for CUDA tensors and runs the
plain version for CPU tensors; ``impl="ref"`` runs the plain version
explicitly; ``impl="cuda"`` insists on the kernel and raises for anything
it does not take.  There is no fallback from a kernel to its plain
version.  ``quantize_rows.launches`` and ``dequantize_rows.launches``
count kernel launches, and ``quantize_rows.launches_by_shape`` counts
them by ``(rows, cols)``.

The kernels take contiguous rows.  The int8 sync hands them the float32
sum ``x + residual``, a fresh contiguous tensor even when ``x`` is a
layer slice ``p[:, lo:hi]`` of a worker-stacked leaf, so no extra copy
is made for them.

The quantize kernel reads each row once; :func:`quantize_geometry`
chooses how a row is cut over threads and is passed to the C entry.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from .. import _build
from .._cost import KernelCost, plain_scope, report
from .ref import dequantize_rows_ref, quantize_rows_ref

__all__ = ["quantize_rows", "dequantize_rows", "quantize", "dequantize",
           "int8_cost",
           "quantize_geometry", "REGISTER_GEOMETRY", "LOOP_THREADS",
           "MAX_STAGED"]

# The register kernel's rows: (widest row, threads per row T, float4
# groups per thread V), each row held as 4V floats in each of T threads.
# The library lists the (T, V) it instantiates (quantize_rows_geometry in
# csrc/int8_quant.cu), and loading it checks them against this table.
REGISTER_GEOMETRY = ((512, 32, 4), (2048, 128, 4), (8192, 256, 8),
                     (16384, 512, 8))
LOOP_THREADS = 1024     # one block a row beyond the register geometry
MAX_STAGED = 57344      # floats of a row in shared memory (224 KB)

_fns: dict[str, ctypes._CFuncPtr] = {}


def _check_geometry(lib: ctypes.CDLL) -> None:
    n = len(REGISTER_GEOMETRY)
    threads, vecs = (ctypes.c_int * n)(), (ctypes.c_int * n)()
    got = lib.quantize_rows_geometry(threads, vecs, n)
    compiled = list(zip(threads[:min(got, n)], vecs[:min(got, n)]))
    if got != n or compiled != [g[1:] for g in REGISTER_GEOMETRY]:
        raise RuntimeError(f"int8_quant.cu compiles {got} register "
                           f"geometries {compiled}, ops.py's table is "
                           f"{REGISTER_GEOMETRY}")


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib = _build.library("int8_quant")
        if not _fns:
            _check_geometry(lib)
        fn = getattr(lib, f"{name}_f32")
        # cols, vec (+ threads, vecs, staged)
        ints = 5 if name == "quantize_rows" else 2
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] \
            + [ctypes.c_int] * ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def quantize_geometry(cols: int) -> tuple[int, int, bool]:
    """How the quantize kernel cuts a row of ``cols`` floats: (threads per
    row, float4 groups per thread, staged).  The narrowest register row
    that holds ``cols``; beyond those, one ``LOOP_THREADS`` block a row
    (groups 0), its row staged in shared memory up to ``MAX_STAGED``
    floats and read twice from device memory beyond."""
    for width, threads, vecs in REGISTER_GEOMETRY:
        if cols <= width:
            return threads, vecs, False
    return LOOP_THREADS, 0, cols <= MAX_STAGED


def _impl(impl: str | None, t: torch.Tensor, name: str) -> str:
    if impl is None:
        return "cuda" if t.is_cuda else "ref"
    if impl not in ("ref", "cuda"):
        raise ValueError(f"unknown {name} impl {impl!r}")
    if impl == "cuda" and not t.is_cuda:
        raise ValueError(f"{name} impl='cuda' needs CUDA tensors")
    return impl


def _launch(name: str, a, b, c, rows: int, cols: int, vec: bool,
            device, *geometry: int) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _fn(name)(a.data_ptr(), b.data_ptr(), c.data_ptr(), rows,
                        cols, int(vec), *geometry, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def int8_cost(name: str, rows: int, cols: int) -> KernelCost:
    """One launch of ``quantize_rows`` or ``dequantize_rows`` over ``[rows,
    cols]``: the float32 and int8 elements and the row scales moved once;
    5 operations an element to quantize, 1 to dequantize."""
    n = rows * cols
    return KernelCost(name, 0.0, (5 if name == "quantize_rows" else 1) * n,
                      n * 5 + rows * 4)


def quantize_rows(x: torch.Tensor, *, impl: str | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x ``[R, C]`` float32 -> (q ``[R, C]`` int8, scale ``[R, 1]``
    float32): ``scale = max|x|/127 + 1e-12``, ``q = clip(round_half_even(
    x / scale), -127, 127)``."""
    if impl is None and x.is_meta:
        report(int8_cost("quantize_rows", *x.shape))
        return (torch.empty(x.shape, dtype=torch.int8, device="meta"),
                torch.empty(x.shape[0], 1, device="meta"))
    if _impl(impl, x, "quantize_rows") == "ref":
        with plain_scope("quantize_rows"):
            return quantize_rows_ref(x)
    if x.dtype != torch.float32:
        raise TypeError(f"quantize_rows kernel takes float32, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"quantize_rows kernel takes contiguous [R, C], "
                         f"got {tuple(x.shape)} strides {x.stride()}")
    rows, cols = x.shape
    q = torch.empty(rows, cols, dtype=torch.int8, device=x.device)
    scale = torch.empty(rows, 1, dtype=torch.float32, device=x.device)
    vec = cols % 4 == 0 and x.data_ptr() % 16 == 0 and q.data_ptr() % 4 == 0
    threads, vecs, staged = quantize_geometry(cols)
    _launch("quantize_rows", x, q, scale, rows, cols, vec, x.device,
            threads, vecs, int(staged))
    quantize_rows.launches += 1
    quantize_rows.launches_by_shape[(rows, cols)] += 1
    return q, scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor, *,
                    impl: str | None = None) -> torch.Tensor:
    """q ``[R, C]`` int8, scale ``[R, 1]`` float32 -> ``q * scale``
    ``[R, C]`` float32."""
    if impl is None and q.is_meta:
        report(int8_cost("dequantize_rows", *q.shape))
        return torch.empty(q.shape, device="meta")
    if _impl(impl, q, "dequantize_rows") == "ref":
        with plain_scope("dequantize_rows"):
            return dequantize_rows_ref(q, scale)
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"dequantize_rows kernel takes int8 codes and "
                        f"float32 scales, got {q.dtype}, {scale.dtype}")
    if q.dim() != 2 or scale.shape != (q.shape[0], 1) \
            or scale.device != q.device:
        raise ValueError(f"dequantize_rows: q {tuple(q.shape)} and scale "
                         f"{tuple(scale.shape)} on {scale.device}: want "
                         "[R, C] and [R, 1] on one device")
    if not q.is_contiguous() or not scale.is_contiguous():
        raise ValueError("dequantize_rows kernel takes contiguous tensors")
    rows, cols = q.shape
    out = torch.empty(rows, cols, dtype=torch.float32, device=q.device)
    vec = cols % 4 == 0 and q.data_ptr() % 4 == 0 \
        and out.data_ptr() % 16 == 0
    _launch("dequantize_rows", q, scale, out, rows, cols, vec, q.device)
    dequantize_rows.launches += 1
    return out


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``quantize``: :func:`quantize_rows` (the kernel on
    a CUDA operand, the plain version on the CPU)."""
    return quantize_rows(x)


def dequantize(q: torch.Tensor, s: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The reference's ``dequantize``: :func:`dequantize_rows`, the
    values in ``dtype``."""
    return dequantize_rows(q, s).to(dtype)


quantize_rows.launches = 0
quantize_rows.launches_by_shape = collections.Counter()
dequantize_rows.launches = 0
