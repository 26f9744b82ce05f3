"""Public wrapper of the fused AdamW kernel: CUDA on the card, the plain
version on the CPU.

``impl=None`` launches the CUDA kernel for CUDA tensors and runs
:func:`fused_adamw_ref` for CPU tensors; ``impl="ref"`` runs the plain
version explicitly; ``impl="cuda"`` insists on the kernel and raises for
anything it does not take.  There is no fallback from the kernel to the
plain version.  ``fused_adamw.launches`` counts kernel launches.

Both update ``p``, ``m`` and ``v`` in place (the TPU kernel returns new
arrays; the optimizer's state is the caller's to reuse).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import fused_adamw_ref

__all__ = ["fused_adamw"]

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_fns: dict[torch.dtype, ctypes._CFuncPtr] = {}


def _fn(dtype: torch.dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(_build.library("fused_adam_sync"),
                     f"fused_adamw_{_SUFFIX[dtype]}")
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def _check(p, g, m, v, hyper) -> None:
    if not p.is_cuda:
        raise ValueError("fused_adamw impl='cuda' needs CUDA tensors")
    if p.dtype not in _SUFFIX:
        raise TypeError(f"fused_adamw kernel takes float32 or bfloat16 "
                        f"parameters, got {p.dtype}")
    for name, t in (("g", g), ("m", m), ("v", v)):
        if t.device != p.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on p's device")
        if t.shape != p.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != p "
                             f"{tuple(p.shape)}")
    if hyper.device != p.device or hyper.dtype != torch.float32 \
            or hyper.shape != (6,):
        raise ValueError("hyper must be a [6] float32 tensor on p's device")
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v),
                    ("hyper", hyper)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    ptrs = {t.data_ptr() for t in (p, g, m, v)}
    if len(ptrs) != 4:
        raise ValueError("p, g, m and v must be distinct tensors")


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def fused_adamw(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, hyper: torch.Tensor, *,
                impl: str | None = None) -> None:
    """One fused AdamW step, in place on ``p``, ``m``, ``v``.

    ``p`` any shape in float32 or bfloat16; ``g``, ``m``, ``v`` the same
    shape in float32; ``hyper`` a ``[6]`` float32 tensor ``[lr, beta1,
    beta2, eps, weight_decay, step + 1]`` on the same device.
    """
    if impl is None:
        impl = "cuda" if p.is_cuda else "ref"
    if impl == "ref":
        fused_adamw_ref(p, g, m, v, hyper)
        return
    if impl != "cuda":
        raise ValueError(f"unknown fused_adamw impl {impl!r}")
    _check(p, g, m, v, hyper)
    vec = int(_aligned(g, m, v) and p.data_ptr() % (4 * p.element_size())
              == 0)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    err = _fn(p.dtype)(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                       v.data_ptr(), hyper.data_ptr(), p.numel(), vec, stream)
    if err:
        raise RuntimeError(f"fused_adamw kernel launch failed: CUDA error "
                           f"{err}")
    fused_adamw.launches += 1


fused_adamw.launches = 0
