"""Fused AdamW step (CUDA kernel + plain version)."""

from .ops import fused_adamw
from .ref import fused_adamw_ref

__all__ = ["fused_adamw", "fused_adamw_ref"]
