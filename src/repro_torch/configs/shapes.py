"""Assigned input shapes (one set, shared by all LM-family archs).

Counterpart of ``repro.configs.shapes``, copied.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ShapeSpec", "SHAPES"]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"

    @property
    def is_serving(self) -> bool:
        return self.kind != "train"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}
