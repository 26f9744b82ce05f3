"""Mamba-2 SSD chunk-local core (CUDA kernel + plain version)."""

from .ops import ssd_chunk, ssd_chunk_grouped
from .ref import ssd_chunk_grouped_ref, ssd_chunk_ref

__all__ = ["ssd_chunk", "ssd_chunk_grouped", "ssd_chunk_ref",
           "ssd_chunk_grouped_ref"]
