"""Worker-axis communication formats of the port (int8 + error feedback)."""

from .compression import (compressed_worker_mean, dequantize_int8,
                          quantize_int8)

__all__ = ["compressed_worker_mean", "dequantize_int8", "quantize_int8"]
