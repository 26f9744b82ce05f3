"""Public wrapper of the fused AdamW kernel: CUDA on the card, the plain
version on the CPU.

``impl=None`` launches the CUDA kernel for CUDA tensors and runs
:func:`fused_adamw_ref` for CPU tensors; ``impl="ref"`` runs the plain
version explicitly; ``impl="cuda"`` insists on the kernel and raises for
anything it does not take.  There is no fallback from the kernel to the
plain version.  ``fused_adamw.launches`` counts kernel launches.

Both update ``p``, ``m`` and ``v`` in place (the TPU kernel returns new
arrays; the optimizer's state is the caller's to reuse).
:func:`fused_adamw_step` and :func:`fused_adamw_tree` take the
reference's signatures (``repro/kernels/fused_adam_sync/ops.py``) over
the same wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._cost import KernelCost, plain_scope, report
from ...tree import tree_leaves
from .ref import adamw_hyper, fused_adamw_ref

__all__ = ["fused_adamw", "fused_adamw_step", "fused_adamw_tree",
           "adamw_cost", "ADAM_FLOPS_PER_ELEMENT"]

ADAM_FLOPS_PER_ELEMENT = 15        # mul/add/div/sqrt of one AdamW update

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


def adamw_cost(p: torch.Tensor) -> KernelCost:
    """One launch's work: p, m and v read and written, g read."""
    n = p.numel()
    return KernelCost("fused_adamw", 0.0, ADAM_FLOPS_PER_ELEMENT * n,
                      n * (2 * p.element_size() + 5 * 4))


def fused_adamw(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, hyper: torch.Tensor, *,
                impl: str | None = None) -> None:
    """One fused AdamW step, in place on ``p``, ``m``, ``v``.

    ``p`` any shape in float32 or bfloat16; ``g``, ``m``, ``v`` the same
    shape in float32; ``hyper`` a ``[6]`` float32 tensor ``[lr, beta1,
    beta2, eps, weight_decay, step + 1]`` on the same device.  On
    ``meta`` tensors it reports :func:`adamw_cost`.
    """
    if impl is None and p.is_meta:
        report(adamw_cost(p))
        return
    if impl is None:
        impl = "cuda" if p.is_cuda else "ref"
    if impl == "ref":
        with plain_scope("fused_adamw"):
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


def fused_adamw_step(p, g, m, v, lr, step, *, beta1=0.9, beta2=0.999,
                     eps=1e-8, weight_decay=0.0, block=1024):
    """The reference's ``fused_adamw_step``: one AdamW step of a tensor
    quartet through :func:`fused_adamw` (the kernel on CUDA operands,
    the plain version on the CPU), returning ``(p, m, v)``.

    **In place**: the returned tensors are ``p``, ``m`` and ``v``
    themselves, updated (the reference returns new arrays; ROADMAP C5).
    ``g`` may be any float dtype (taken in float32); ``block`` is the
    Pallas tile and is ignored, the CUDA kernel chooses its own."""
    del block
    fused_adamw(p, g.float(), m, v, adamw_hyper(
        lr, step, beta1=beta1, beta2=beta2, eps=eps,
        weight_decay=weight_decay, device=p.device))
    return p, m, v


def fused_adamw_tree(params, grads, ms, vs, lr, step, **kw):
    """:func:`fused_adamw_step` leaf by leaf over parameter trees (nested
    dicts, leaves in sorted-key order); returns ``(params, ms, vs)``,
    updated **in place** like the step."""
    for leaves in zip(*(tree_leaves(t) for t in (params, grads, ms, vs)),
                      strict=True):
        fused_adamw_step(*leaves, lr, step, **kw)
    return params, ms, vs
