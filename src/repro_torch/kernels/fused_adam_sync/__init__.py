"""Fused AdamW step and the global-norm clip it reads (CUDA kernels +
plain versions), and the reference's names over them."""

from .ops import (clip_partials, clip_scale, fused_adamw, fused_adamw_step,
                  fused_adamw_tree)
from .ref import adamw_ref, clip_scale_ref, fused_adamw_ref

__all__ = ["fused_adamw", "fused_adamw_ref", "fused_adamw_step",
           "fused_adamw_tree", "adamw_ref", "clip_scale", "clip_scale_ref",
           "clip_partials"]
