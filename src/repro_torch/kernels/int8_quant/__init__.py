"""Per-row symmetric int8 quantize / dequantize (CUDA kernels + plain
versions), and the reference's ``quantize`` / ``dequantize`` over them."""

from .ops import dequantize, dequantize_rows, quantize, quantize_rows
from .ref import dequantize_rows_ref, quantize_rows_ref

__all__ = ["quantize_rows", "dequantize_rows", "quantize", "dequantize",
           "quantize_rows_ref", "dequantize_rows_ref"]
