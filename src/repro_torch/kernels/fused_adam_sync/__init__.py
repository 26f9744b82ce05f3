"""Fused AdamW step (CUDA kernel + plain version), and the reference's
names over them."""

from .ops import fused_adamw, fused_adamw_step, fused_adamw_tree
from .ref import adamw_ref, fused_adamw_ref

__all__ = ["fused_adamw", "fused_adamw_ref", "fused_adamw_step",
           "fused_adamw_tree", "adamw_ref"]
