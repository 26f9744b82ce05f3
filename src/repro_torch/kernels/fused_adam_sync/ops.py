"""Public wrappers of the fused AdamW kernel and of the global-norm
clip it reads: CUDA on the card, the plain versions on the CPU.

``impl=None`` launches the CUDA kernels for CUDA tensors and runs
:func:`fused_adamw_ref` / :func:`clip_scale_ref` for CPU tensors;
``impl="ref"`` runs the plain versions explicitly; ``impl="cuda"``
insists on the kernels and raises for anything they do not take.  There
is no fallback from a kernel to its plain version.
``fused_adamw.launches`` counts AdamW launches, ``.scaled_launches``
those that took a clip scale or read ``g`` below float32;
``clip_scale.launches`` counts norm passes (each a launch a leaf and
one to finish).

Both AdamW paths update ``p``, ``m`` and ``v`` in place (the TPU kernel
returns new arrays; the optimizer's state is the caller's to reuse).
:func:`fused_adamw_step` and :func:`fused_adamw_tree` take the
reference's signatures (``repro/kernels/fused_adam_sync/ops.py``) over
the same wrapper.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .._cost import KernelCost, plain_scope, report
from ...tree import tree_leaves
from .ref import adamw_hyper, clip_scale_ref, fused_adamw_ref

__all__ = ["fused_adamw", "fused_adamw_step", "fused_adamw_tree",
           "adamw_cost", "ADAM_FLOPS_PER_ELEMENT", "clip_scale",
           "clip_partials"]

ADAM_FLOPS_PER_ELEMENT = 15        # mul/add/div/sqrt of one AdamW update

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_fns: dict[tuple, ctypes._CFuncPtr] = {}

_NORM_THREADS = 256                # a norm block's threads (the kernel's)
_NORM_MIN_PER_THREAD = 16          # elements a thread reads at the least
_NORM_BLOCKS_PER_SM = 8            # the grid's cap: 8 blocks an SM


def _fn(p_dtype: torch.dtype, g_dtype: torch.dtype):
    key = (p_dtype, g_dtype)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(_build.library("fused_adam_sync"),
                     f"fused_adamw_{_SUFFIX[p_dtype]}_{_SUFFIX[g_dtype]}")
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


@functools.cache
def _norm_fns() -> dict:
    """The norm kernels' entry points: one a leaf dtype, and
    ``"finalize"``."""
    lib = _build.library("fused_adam_sync")
    fns = {}
    for dtype, suffix in _SUFFIX.items():
        fn = getattr(lib, f"grad_sumsq_{suffix}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    fin = lib.clip_scale_finalize
    fin.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                    ctypes.c_void_p, ctypes.c_void_p]
    fin.restype = ctypes.c_int
    fns["finalize"] = fin
    return fns


def _check(p, g, m, v, hyper, scale) -> None:
    if not p.is_cuda:
        raise ValueError("fused_adamw impl='cuda' needs CUDA tensors")
    if p.dtype not in _SUFFIX:
        raise TypeError(f"fused_adamw kernel takes float32 or bfloat16 "
                        f"parameters, got {p.dtype}")
    if g.dtype not in _SUFFIX:
        raise TypeError(f"fused_adamw kernel takes float32 or bfloat16 "
                        f"gradients, got {g.dtype}")
    if g.device != p.device:
        raise ValueError("g must be on p's device")
    for name, t in (("m", m), ("v", v)):
        if t.device != p.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on p's device")
    for name, t in (("g", g), ("m", m), ("v", v)):
        if t.shape != p.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != p "
                             f"{tuple(p.shape)}")
    if hyper.device != p.device or hyper.dtype != torch.float32 \
            or hyper.shape != (6,):
        raise ValueError("hyper must be a [6] float32 tensor on p's device")
    if scale is not None and (scale.device != p.device
                              or scale.dtype != torch.float32
                              or scale.numel() != 1 or scale.dim() > 1):
        raise ValueError("scale must be a [1] or 0-d float32 tensor on p's "
                         "device")
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v),
                    ("hyper", hyper)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    ptrs = {t.data_ptr() for t in (p, g, m, v)}
    if len(ptrs) != 4:
        raise ValueError("p, g, m and v must be distinct tensors")


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def adamw_cost(p: torch.Tensor, g: torch.Tensor | None = None
               ) -> KernelCost:
    """One launch's work: p, m and v read and written, g read (in its
    own dtype; float32 when not given)."""
    n = p.numel()
    g_bytes = 4 if g is None else g.element_size()
    return KernelCost("fused_adamw", 0.0, ADAM_FLOPS_PER_ELEMENT * n,
                      n * (2 * p.element_size() + g_bytes + 4 * 4))


def fused_adamw(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, hyper: torch.Tensor, *,
                scale: torch.Tensor | None = None,
                impl: str | None = None) -> None:
    """One fused AdamW step, in place on ``p``, ``m``, ``v``.

    ``p`` any shape in float32 or bfloat16; ``g`` the same shape in
    float32 or bfloat16 (the plain version takes any float dtype);
    ``m``, ``v`` the same shape in float32; ``hyper`` a ``[6]`` float32
    tensor ``[lr, beta1, beta2, eps, weight_decay, step + 1]`` on the
    same device; ``scale`` a ``[1]`` or 0-d float32 tensor there, the
    clip's scale that multiplies ``g`` as it is read, or ``None``.  On
    ``meta`` tensors it reports :func:`adamw_cost`.
    """
    if impl is None and p.is_meta:
        report(adamw_cost(p, g))
        return
    if impl is None:
        impl = "cuda" if p.is_cuda else "ref"
    if impl == "ref":
        with plain_scope("fused_adamw"):
            fused_adamw_ref(p, g, m, v, hyper, scale)
        return
    if impl != "cuda":
        raise ValueError(f"unknown fused_adamw impl {impl!r}")
    _check(p, g, m, v, hyper, scale)
    vec = int(_aligned(m, v) and all(t.data_ptr() % (4 * t.element_size())
                                     == 0 for t in (p, g)))
    stream = torch.cuda.current_stream(p.device).cuda_stream
    err = _fn(p.dtype, g.dtype)(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
        hyper.data_ptr(), None if scale is None else scale.data_ptr(),
        p.numel(), vec, stream)
    if err:
        raise RuntimeError(f"fused_adamw kernel launch failed: CUDA error "
                           f"{err}")
    fused_adamw.launches += 1
    if scale is not None or g.dtype != torch.float32:
        fused_adamw.scaled_launches += 1


fused_adamw.launches = 0
fused_adamw.scaled_launches = 0


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _norm_blocks(n: int, sms: int) -> int:
    """The norm kernel's blocks for a leaf of ``n`` elements on a card of
    ``sms`` SMs: at least 16 elements a thread, at most 8 blocks an SM
    (none for an empty leaf).  A pure function of the two, so a leaf's
    partials sit at the same place in every call."""
    per_block = _NORM_THREADS * _NORM_MIN_PER_THREAD
    return min(-(-n // per_block), _NORM_BLOCKS_PER_SM * sms)


def clip_partials(leaves) -> int:
    """The float32 partial sums a :func:`clip_scale` pass over ``leaves``
    (CUDA tensors) writes: its scratch holds these and two more."""
    sms = _sms(leaves[0].device.index or 0)
    return sum(_norm_blocks(x.numel(), sms) for x in leaves)


def clip_scale(leaves, max_norm: float, scratch: torch.Tensor | None = None,
               *, impl: str | None = None) -> torch.Tensor:
    """The global-norm clip's scale over every leaf together,
    ``min(max_norm / (norm + 1e-9), 1)``, as a float32 tensor on the
    leaves' device: one norm over the whole (worker-stacked) tree, as
    the reference takes it (ROADMAP C2).

    On CUDA (``impl="cuda"``): contiguous float32 or bfloat16 leaves,
    each read once by the norm kernel, and ``scratch``, a float32 tensor
    of ``clip_partials(leaves) + 2`` elements that the caller owns (a
    captured graph keeps reading it): the partials, then ``[scale, sum
    of squares]``.  Returns ``scratch[-2:-1]``, written on the current
    stream.  The plain version (``impl="ref"``, CPU and meta tensors)
    is the reference's ``torch.dot`` composition, a 0-d tensor; its dots
    are counted as the reference's own.
    """
    if impl is None:
        impl = "cuda" if leaves[0].is_cuda else "ref"
    if impl == "ref":
        return clip_scale_ref(leaves, max_norm)
    if impl != "cuda":
        raise ValueError(f"unknown clip_scale impl {impl!r}")
    dev = leaves[0].device
    count = clip_partials(leaves)
    if scratch is None or scratch.device != dev or scratch.dtype != \
            torch.float32 or scratch.numel() != count + 2 \
            or not scratch.is_contiguous():
        raise ValueError(f"scratch must be a contiguous float32 tensor of "
                         f"{count + 2} elements on {dev}")
    for x in leaves:
        if x.device != dev or x.dtype not in _SUFFIX \
                or not x.is_contiguous():
            raise ValueError("clip_scale takes contiguous float32 or "
                             "bfloat16 leaves on one CUDA device")
    fns = _norm_fns()
    sms = _sms(dev.index or 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    base, off = scratch.data_ptr(), 0
    for x in leaves:
        blocks = _norm_blocks(x.numel(), sms)
        err = fns[x.dtype](x.data_ptr(), x.numel(), int(_aligned(x)),
                           blocks, base + 4 * off, stream)
        if err:
            raise RuntimeError(f"grad_sumsq kernel launch failed: CUDA "
                               f"error {err}")
        off += blocks
    err = fns["finalize"](base, count, float(max_norm), base + 4 * count,
                          stream)
    if err:
        raise RuntimeError(f"clip_scale kernel launch failed: CUDA error "
                           f"{err}")
    clip_scale.launches += 1
    return scratch[count:count + 1]


clip_scale.launches = 0


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
