"""Plain PyTorch versions of the int8 row kernels (mirror
``repro.kernels.int8_quant.ref`` and ``repro.parallel.compression``).

``torch.round`` rounds half to even, as ``jnp.round`` does, and the scale
and the codes are true divisions, so the codes equal the JAX package's
bit for bit.  The divisor 127 is a tensor on ``x``'s device: PyTorch's
CUDA division by a Python scalar multiplies by its reciprocal, which
moves the scale by an ulp and flips codes on ties.  The CPU path of the int8 sync runs these; on the card
``chip_smoke.py`` holds the kernels against them.
"""

from __future__ import annotations

import torch

__all__ = ["int8_scale", "quantize_rows_ref", "dequantize_rows_ref"]


def int8_scale(x: torch.Tensor, dim: int = 1
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(x in float32, its symmetric int8 scale ``max|x| / 127 + 1e-12``
    along ``dim``, kept as size 1)."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    return xf, amax / torch.full_like(amax, 127.0) + 1e-12


def quantize_rows_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x ``[R, C]`` -> (q ``[R, C]`` int8, scale ``[R, 1]`` float32)."""
    xf, scale = int8_scale(x)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_rows_ref(q: torch.Tensor, scale: torch.Tensor
                        ) -> torch.Tensor:
    """q ``[R, C]`` int8, scale ``[R, 1]`` -> ``[R, C]`` float32: one
    promoting multiply, float(q) * scale."""
    return torch.mul(q, scale)
