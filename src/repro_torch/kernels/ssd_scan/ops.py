"""Public wrappers of the SSD chunk kernel: CUDA on the card, the plain
version on the CPU.

Two entries launch the same kernel, which reads its operands by stride:

* :func:`ssd_chunk_grouped` takes the model's own layout, x ``[B, Lp,
  H, p]``, b/c ``[B, Lp, G, n]``, da ``[B, Lp, H]`` with ``Lp`` a
  multiple of the chunk, and writes y ``[B, Lp, H, p]``; head ``h``
  reads group ``h // (H // G)``.  The Mamba-2 prefill calls it with the
  views it has (b and c are slices of the conv output): no transposed
  copy and no head repeat.
* :func:`ssd_chunk` takes the TPU kernel's layout, x ``[B, NC, H, cs,
  p]``, b/c ``[B, NC, H, cs, n]``, da ``[B, NC, H, cs]`` (one group per
  head).

``impl=None`` launches the CUDA kernel for CUDA tensors and runs the
plain version for CPU tensors; ``impl="ref"`` runs the plain version
explicitly; ``impl="cuda"`` insists on the kernel and raises for
anything it does not take.  There is no fallback from the kernel to the
plain version.  The kernel has no backward (nor has the TPU kernel), so
the wrappers refuse inputs that need a gradient on every path.  Each
wrapper's ``launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import ssd_chunk_grouped_ref, ssd_chunk_ref

__all__ = ["ssd_chunk", "ssd_chunk_grouped", "smem_bytes",
           "grouped_launch_args", "chunk_launch_args"]

# what the kernel is built for (csrc/ssd_scan.cu)
MAX_CS, MAX_P, MAX_N = 256, 128, 256
SMEM_LIMIT = 232_448                 # dynamic shared memory a block may use
_BC_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_fns: dict[torch.dtype, ctypes._CFuncPtr] = {}


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def smem_bytes(cs: int, p: int, n: int,
               bc_dtype: torch.dtype = torch.float32) -> int:
    """Shared memory of one block (``make_geo`` / ``smem_bytes`` in the
    source): cum and the state decay, X (rows of p rounded up to 32,
    plus 4 floats) and B and C (n rounded up to 32, plus 16 bytes), for
    cs rounded up to 16 rows."""
    rp, es = _round_up(cs, 16), 2 if bc_dtype == torch.bfloat16 else 4
    ldx = _round_up(p, 32) + 4
    ldb = _round_up(n, 32) + 16 // es
    return 4 * (2 * rp + rp * ldx) + 2 * es * rp * ldb


def _fn(bc_dtype: torch.dtype):
    fn = _fns.get(bc_dtype)
    if fn is None:
        fn = getattr(_build.library("ssd_scan"),
                     f"ssd_chunk_fwd_xf32_bc{_BC_SUFFIX[bc_dtype]}")
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
            + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[bc_dtype] = fn
    return fn


def _no_grad(x, b, c, da) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, b, c, da)):
        raise RuntimeError("ssd_chunk has no backward: call it under "
                           "torch.no_grad() or on tensors that need no "
                           "gradient")


def _check_dtypes(x, b, c, da) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"ssd_chunk kernel takes float32 x (the model "
                        f"hands it x * dt), got {x.dtype}")
    if b.dtype not in _BC_SUFFIX or c.dtype != b.dtype:
        raise TypeError(f"ssd_chunk kernel takes b and c both float32 or "
                        f"both bfloat16, got {b.dtype} and {c.dtype}")
    if da.dtype != torch.float32:
        raise TypeError(f"ssd_chunk kernel takes float32 da, got "
                        f"{da.dtype}")


def _check_widths(cs: int, p: int, n: int, bc_dtype: torch.dtype) -> None:
    if not (1 <= cs <= MAX_CS and 1 <= p <= MAX_P and 1 <= n <= MAX_N):
        raise ValueError(f"cs {cs}, p {p}, n {n}: the kernel takes cs <= "
                         f"{MAX_CS}, p <= {MAX_P}, n <= {MAX_N}")
    n_mult = 16 // torch.tensor([], dtype=bc_dtype).element_size()
    if p % 4 or n % n_mult:
        raise ValueError(f"p {p}, n {n}: the kernel copies rows in 16-byte "
                         f"pieces, so p must be a multiple of 4 and n of "
                         f"{n_mult}")
    need = smem_bytes(cs, p, n, bc_dtype)
    if need > SMEM_LIMIT:
        raise ValueError(f"cs {cs}, p {p}, n {n} need {need} bytes of "
                         f"shared memory (> {SMEM_LIMIT})")


def _check_layout(t: torch.Tensor, name: str, dims: tuple[int, ...]) -> None:
    """The last dimension is contiguous and rows start on 16 bytes: the
    data pointer and the strides of ``dims`` that index more than one
    element are multiples of 16 bytes."""
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        raise ValueError(f"{name} must be contiguous in its last dimension")
    walked = tuple(t.stride(d) for d in dims if t.shape[d] > 1)
    if t.data_ptr() % 16 or any(s * t.element_size() % 16 for s in walked):
        raise ValueError(f"{name} must be 16-byte aligned (data pointer "
                         f"and row strides {walked})")


def grouped_launch_args(x, b, c, da, chunk: int
                        ) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """The checks of :func:`ssd_chunk_grouped` that read no tensor data
    (dtypes, shapes, widths, strides, alignment) and the kernel's
    arguments: the dims ``(B, NC, H, G, cs, p, n)`` and 20 strides,
    (batch, chunk, row, head or group) of x, b, c, da and y in turn, y
    being the contiguous ``[B, Lp, H, p]`` output."""
    _check_dtypes(x, b, c, da)
    if x.dim() != 4 or b.dim() != 4 or c.shape != b.shape or da.dim() != 3:
        raise ValueError(
            f"shapes x {tuple(x.shape)}, b {tuple(b.shape)}, c "
            f"{tuple(c.shape)}, da {tuple(da.shape)}: want x [B, Lp, H, p], "
            "b == c [B, Lp, G, n], da [B, Lp, H]")
    bsz, lp, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if b.shape[:2] != x.shape[:2] or da.shape != x.shape[:3] or h % g:
        raise ValueError(f"x {tuple(x.shape)}, b {tuple(b.shape)} and da "
                         f"{tuple(da.shape)} disagree on [B, Lp, H] or H is "
                         "not a multiple of G")
    if chunk < 1 or lp % chunk:
        raise ValueError(f"Lp {lp} is not a multiple of the chunk {chunk}")
    _check_widths(chunk, p, n, b.dtype)
    for name, t in (("x", x), ("b", b), ("c", c)):
        _check_layout(t, name, (0, 1, 2))

    def rows(st):     # (batch, chunk, row, head or group)
        return (st[0], chunk * st[1], st[1], st[2])

    y_strides = (lp * h * p, h * p, p, 1)
    strides = sum((rows(t.stride()) for t in (x, b, c, da)), ()) \
        + rows(y_strides)
    return (bsz, lp // chunk, h, g, chunk, p, n), strides


def chunk_launch_args(x, b, c, da
                      ) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """As :func:`grouped_launch_args`, for :func:`ssd_chunk`'s TPU layout
    (G = H; y the contiguous ``[B, NC, H, cs, p]`` output)."""
    _check_dtypes(x, b, c, da)
    if x.dim() != 5 or b.dim() != 5 or c.shape != b.shape or da.dim() != 4:
        raise ValueError(
            f"shapes x {tuple(x.shape)}, b {tuple(b.shape)}, c "
            f"{tuple(c.shape)}, da {tuple(da.shape)}: want x [B, NC, H, cs, "
            "p], b == c [B, NC, H, cs, n], da [B, NC, H, cs]")
    if b.shape[:4] != x.shape[:4] or da.shape != x.shape[:4]:
        raise ValueError(f"x {tuple(x.shape)}, b {tuple(b.shape)} and da "
                         f"{tuple(da.shape)} disagree on [B, NC, H, cs]")
    bsz, nc, h, cs, p = x.shape
    n = b.shape[4]
    _check_widths(cs, p, n, b.dtype)
    for name, t in (("x", x), ("b", b), ("c", c)):
        _check_layout(t, name, (0, 1, 2, 3))

    def rows(st):     # (batch, chunk, row, head): dims 0, 1, 3, 2
        return (st[0], st[1], st[3], st[2])

    y_strides = (nc * h * cs * p, h * cs * p, cs * p, p)
    strides = sum((rows(t.stride()) for t in (x, b, c)), ()) \
        + rows(da.stride() + (1,)) + rows(y_strides)
    return (bsz, nc, h, h, cs, p, n), strides


def _launch(x, b, c, da, y, states, dims, strides) -> None:
    arr = (ctypes.c_longlong * 20)(*strides)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):       # the attribute and the launch
        err = _fn(b.dtype)(x.data_ptr(), b.data_ptr(), c.data_ptr(),
                           da.data_ptr(), y.data_ptr(), states.data_ptr(),
                           *dims, arr, stream)
    if err:
        raise RuntimeError(f"ssd_chunk kernel launch failed: CUDA error "
                           f"{err}")


def _run(x, b, c, da, dims, strides, y_shape):
    """Check that the operands share x's device, allocate the outputs
    and launch unless there is no cell; returns (y, states, launched)."""
    for name, t in (("b", b), ("c", c), ("da", da)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    bsz, nc, h, _, _, p, n = dims
    y = torch.empty(y_shape, dtype=torch.float32, device=x.device)
    states = torch.empty(bsz, nc, h, p, n, dtype=torch.float32,
                         device=x.device)
    launched = bsz * nc * h > 0
    if launched:
        _launch(x, b, c, da, y, states, dims, strides)
    return y, states, launched


def ssd_chunk_grouped(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                      da: torch.Tensor, chunk: int, *,
                      impl: str | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk-local SSD in the model's layout: x ``[B, Lp, H, p]``, b/c
    ``[B, Lp, G, n]`` (``H % G == 0``), da ``[B, Lp, H]``, ``Lp`` a
    multiple of ``chunk`` -> (y_diag ``[B, Lp, H, p]`` in x's dtype,
    states ``[B, Lp // chunk, H, p, n]`` float32).  Operands may be
    strided views (the last dimension contiguous)."""
    _no_grad(x, b, c, da)
    if impl is None:
        impl = "cuda" if x.is_cuda else "ref"
    if impl == "ref":
        return ssd_chunk_grouped_ref(x, b, c, da, chunk)
    if impl != "cuda":
        raise ValueError(f"unknown ssd_chunk_grouped impl {impl!r}")
    if not x.is_cuda:
        raise ValueError("ssd_chunk impl='cuda' needs CUDA tensors")
    dims, strides = grouped_launch_args(x, b, c, da, chunk)
    y, states, launched = _run(x, b, c, da, dims, strides, x.shape)
    ssd_chunk_grouped.launches += launched
    return y, states


def ssd_chunk(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              da: torch.Tensor, *, impl: str | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk-local SSD in the TPU kernel's layout: x ``[B, NC, H, cs,
    p]``, b/c ``[B, NC, H, cs, n]``, da ``[B, NC, H, cs]`` -> (y_diag
    ``[B, NC, H, cs, p]`` in x's dtype, states ``[B, NC, H, p, n]``
    float32)."""
    _no_grad(x, b, c, da)
    if impl is None:
        impl = "cuda" if x.is_cuda else "ref"
    if impl == "ref":
        return ssd_chunk_ref(x, b, c, da)
    if impl != "cuda":
        raise ValueError(f"unknown ssd_chunk impl {impl!r}")
    if not x.is_cuda:
        raise ValueError("ssd_chunk impl='cuda' needs CUDA tensors")
    dims, strides = chunk_launch_args(x, b, c, da)
    y, states, launched = _run(x, b, c, da, dims, strides, x.shape)
    ssd_chunk.launches += launched
    return y, states


ssd_chunk.launches = 0
ssd_chunk_grouped.launches = 0
