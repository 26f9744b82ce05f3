"""int8 + error-feedback compression for the slow (pod/WAN) sync axis.

Counterpart of ``repro.parallel.compression``.  Quantizing the synchronized
parameters to int8 with per-row scales, with error feedback absorbing the
quantization noise, cuts the wire bytes ~2x against bfloat16.

Unlike the reference, which leaves its Pallas kernel to tests
(ROADMAP.md C3), the port runs the int8 wire format through the CUDA
row kernels of :mod:`repro_torch.kernels.int8_quant` for CUDA tensors
(their plain versions on the CPU).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..kernels.int8_quant import dequantize_rows, quantize_rows
from ..kernels.int8_quant.ref import int8_scale
from ..tree import tree_map

__all__ = ["EFState", "ef_init", "quantize_int8", "dequantize_int8",
           "compressed_worker_mean"]


class EFState(NamedTuple):
    """Per-leaf error-feedback residuals (float32, worker-stacked)."""

    residual: Any


def ef_init(params) -> EFState:
    """Zero residuals shaped like ``params``, on its leaves' devices."""
    return EFState(tree_map(
        lambda x: torch.zeros(x.shape, dtype=torch.float32,
                              device=x.device), params))


def quantize_int8(x: torch.Tensor, *, axis: int = -1,
                  generator: torch.Generator | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-slice int8 quantization along ``axis`` -> (q int8,
    scale float32 with ``axis`` kept as size 1).

    Round to nearest even goes through the row kernel (CUDA) or its
    plain version (CPU).  ``generator`` adds a uniform dither in
    ``[-0.5, 0.5)`` before rounding (stochastic rounding); the kernel has
    none (nor has the TPU kernel, ROADMAP.md C3), so this is the plain
    version only and CUDA tensors raise.  Its draws are not JAX's.
    """
    if generator is not None:
        if x.is_cuda:
            raise NotImplementedError(
                "stochastic rounding is plain-only: the int8 kernel rounds "
                "to nearest even (ROADMAP.md C3)")
        xf, scale = int8_scale(x, axis)
        y = xf / scale
        y = y + (torch.rand(y.shape, generator=generator) - 0.5)
        return torch.clamp(torch.round(y), -127, 127).to(torch.int8), scale
    xm = x.float().movedim(axis, -1)
    rows = xm.reshape(-1, xm.shape[-1])
    q, scale = quantize_rows(rows.contiguous())
    q = q.reshape(xm.shape).movedim(-1, axis)
    scale = scale.reshape(*xm.shape[:-1], 1).movedim(-1, axis)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q * scale`` in float32, ``scale`` broadcast along the quantized
    axis (the one axis where ``scale`` has size 1 and ``q`` does not)."""
    if scale.dim() != q.dim():
        raise ValueError(f"scale {tuple(scale.shape)} does not match q "
                         f"{tuple(q.shape)}")
    axes = [d for d in range(q.dim())
            if scale.shape[d] == 1 and q.shape[d] != 1]
    if len(axes) > 1 or any(scale.shape[d] not in (1, q.shape[d])
                            for d in range(q.dim())):
        raise ValueError(f"scale {tuple(scale.shape)} is not a per-slice "
                         f"scale of q {tuple(q.shape)}")
    axis = axes[0] if axes else q.dim() - 1
    qm, sm = q.movedim(axis, -1), scale.movedim(axis, -1)
    out = dequantize_rows(qm.reshape(-1, qm.shape[-1]).contiguous(),
                          sm.reshape(-1, 1).contiguous())
    return out.reshape(qm.shape).movedim(-1, axis)


def compressed_worker_mean(x: torch.Tensor, residual: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Worker-mean of ``x`` through an int8 wire format + error feedback.

    ``x`` and ``residual`` are worker-stacked ``[W, ...]`` (any strides:
    ``x + residual`` is a fresh contiguous float32 tensor, which is what
    the row kernels get).  Returns ``(synced, new_residual)``;
    ``synced`` is identical across the worker axis (broadcast view) and
    in ``x``'s dtype.
    """
    xf = x.float() + residual
    q, scale = quantize_int8(xf)
    deq = dequantize_int8(q, scale)
    new_residual = xf - deq
    synced = deq.mean(0, keepdim=True).to(x.dtype).expand_as(x)
    return synced, new_residual
