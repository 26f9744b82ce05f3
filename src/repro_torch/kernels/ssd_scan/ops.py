"""Public wrapper of the SSD chunk kernel: CUDA on the card, the plain
version on the CPU.

``impl=None`` launches the CUDA kernel for CUDA tensors and runs
:func:`ssd_chunk_ref` for CPU tensors; ``impl="ref"`` runs the plain
version explicitly; ``impl="cuda"`` insists on the kernel and raises for
anything it does not take.  There is no fallback from the kernel to the
plain version.  The kernel has no backward (nor has the TPU kernel), so
the wrapper refuses inputs that need a gradient on every path.
``ssd_chunk.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import ssd_chunk_ref

__all__ = ["ssd_chunk"]

# what the kernel is built for (csrc/ssd_scan.cu)
MAX_CS, MAX_P, MAX_N = 256, 128, 256
SMEM_LIMIT = 232_448                 # dynamic shared memory a block may use
_ROWS = 32                           # query rows per tile
_BC_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_fns: dict[torch.dtype, ctypes._CFuncPtr] = {}


def smem_bytes(cs: int, p: int, n: int) -> int:
    """Shared memory of one block: cum, B (rows padded by one), X, a
    tile of C rows (padded) and the tile's scores."""
    rows = min(_ROWS, cs)
    return 4 * (cs + cs * (n + 1) + cs * p + rows * (n + 1) + rows * cs)


def _fn(bc_dtype: torch.dtype):
    fn = _fns.get(bc_dtype)
    if fn is None:
        fn = getattr(_build.library("ssd_scan"),
                     f"ssd_chunk_fwd_xf32_bc{_BC_SUFFIX[bc_dtype]}")
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[bc_dtype] = fn
    return fn


def _check(x, b, c, da) -> None:
    if not x.is_cuda:
        raise ValueError("ssd_chunk impl='cuda' needs CUDA tensors")
    for name, t in (("b", b), ("c", c), ("da", da)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"ssd_chunk kernel takes float32 x (the model "
                        f"hands it x * dt), got {x.dtype}")
    if b.dtype not in _BC_SUFFIX or c.dtype != b.dtype:
        raise TypeError(f"ssd_chunk kernel takes b and c both float32 or "
                        f"both bfloat16, got {b.dtype} and {c.dtype}")
    if da.dtype != torch.float32:
        raise TypeError(f"ssd_chunk kernel takes float32 da, got "
                        f"{da.dtype}")
    if x.dim() != 5 or b.dim() != 5 or c.shape != b.shape or da.dim() != 4:
        raise ValueError(
            f"shapes x {tuple(x.shape)}, b {tuple(b.shape)}, c "
            f"{tuple(c.shape)}, da {tuple(da.shape)}: want x [B, NC, H, cs, "
            "p], b == c [B, NC, H, cs, n], da [B, NC, H, cs]")
    if b.shape[:4] != x.shape[:4] or da.shape != x.shape[:4]:
        raise ValueError(f"x {tuple(x.shape)}, b {tuple(b.shape)} and da "
                         f"{tuple(da.shape)} disagree on [B, NC, H, cs]")
    cs, p, n = x.shape[3], x.shape[4], b.shape[4]
    if not (1 <= cs <= MAX_CS and 1 <= p <= MAX_P and 1 <= n <= MAX_N):
        raise ValueError(f"cs {cs}, p {p}, n {n}: the kernel takes cs <= "
                         f"{MAX_CS}, p <= {MAX_P}, n <= {MAX_N}")
    if smem_bytes(cs, p, n) > SMEM_LIMIT:
        raise ValueError(f"cs {cs}, p {p}, n {n} need "
                         f"{smem_bytes(cs, p, n)} bytes of shared memory "
                         f"(> {SMEM_LIMIT})")
    for name, t in (("x", x), ("b", b), ("c", c), ("da", da)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ssd_chunk(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              da: torch.Tensor, *, impl: str | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk-local SSD: x ``[B, NC, H, cs, p]``, b/c ``[B, NC, H, cs,
    n]``, da ``[B, NC, H, cs]`` -> (y_diag ``[B, NC, H, cs, p]`` in x's
    dtype, states ``[B, NC, H, p, n]`` float32)."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, b, c, da)):
        raise RuntimeError("ssd_chunk has no backward: call it under "
                           "torch.no_grad() or on tensors that need no "
                           "gradient")
    if impl is None:
        impl = "cuda" if x.is_cuda else "ref"
    if impl == "ref":
        return ssd_chunk_ref(x, b, c, da)
    if impl != "cuda":
        raise ValueError(f"unknown ssd_chunk impl {impl!r}")
    _check(x, b, c, da)
    bsz, nc, h, cs, p = x.shape
    n = b.shape[4]
    y = torch.empty_like(x)
    states = torch.empty(bsz, nc, h, p, n, dtype=torch.float32,
                         device=x.device)
    cells = bsz * nc * h
    if cells:
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _fn(b.dtype)(
            x.data_ptr(), b.data_ptr(), c.data_ptr(), da.data_ptr(),
            y.data_ptr(), states.data_ptr(), cells, cs, p, n, stream)
        if err:
            raise RuntimeError(f"ssd_chunk kernel launch failed: CUDA error "
                               f"{err}")
        ssd_chunk.launches += 1
    return y, states


ssd_chunk.launches = 0
