"""Grouped matrix products over expert groups whose offsets live on the
device (CUDA kernel + plain version): the dropless expert layer's
forward, dgrad and wgrad."""

from .ops import LAYOUTS, grouped_cost, grouped_gemm, grouped_mm
from .ref import grouped_gemm_ref

__all__ = ["grouped_gemm", "grouped_mm", "grouped_gemm_ref", "grouped_cost",
           "LAYOUTS"]
