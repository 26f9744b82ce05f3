"""Per-row symmetric int8 quantize / dequantize (CUDA kernels + plain
versions)."""

from .ops import dequantize_rows, quantize_rows
from .ref import dequantize_rows_ref, quantize_rows_ref

__all__ = ["quantize_rows", "dequantize_rows", "quantize_rows_ref",
           "dequantize_rows_ref"]
