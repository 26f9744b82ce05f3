"""ArchSpec — how one architecture plugs into the port.

Counterpart of ``repro.configs.common``: the same fields, worker-axis
rules and batch shapes.  :func:`batch_specs` returns ``meta`` tensors
(shape and dtype, no storage) where the reference returns
``ShapeDtypeStruct``s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from .shapes import SHAPES, ShapeSpec

__all__ = ["ArchSpec", "batch_specs"]


@dataclass(frozen=True)
class ArchSpec:
    """One selectable ``--arch``: the full published config and a reduced
    config of the same family.

    ``large`` archs cannot replicate per data-parallel rank (a full
    divergent replica does not fit 16 chips): their local-SGD worker
    axis is the ``pod`` axis only (W=1 single-pod, W=2 multi-pod) and
    parameters are FSDP-sharded over ``data`` inside the worker.  Small
    archs put workers on (``pod`` x) ``data`` — the paper's 8-32-worker
    regime.
    """

    arch_id: str
    family: str                               # dense|vlm|ssm|hybrid|moe|audio
    make_model: Callable[[], Any]             # full published config
    make_smoke: Callable[[], Any]             # reduced same-family config
    large: bool = False                       # worker axis = pod only + FSDP
    optimizer: str = "adamw"
    sub_quadratic: bool = False               # long_500k runnable
    frontend: str | None = None               # "vision" | "audio"
    n_frontend_tokens: int = 0                # patches / frames prepended
    notes: str = ""

    # ---- shape coverage -----------------------------------------------------
    def shapes(self) -> list[ShapeSpec]:
        """Every shape of :data:`SHAPES` but ``long_500k`` for quadratic
        attention."""
        return [s for s in SHAPES.values()
                if s.name != "long_500k" or self.sub_quadratic]

    def n_workers(self, *, multi_pod: bool) -> int:
        if self.large:
            return 2 if multi_pod else 1
        return 32 if multi_pod else 16

    def worker_axes(self, *, multi_pod: bool) -> tuple[str, ...]:
        if self.large:
            return ("pod",) if multi_pod else ()
        return ("pod", "data") if multi_pod else ("data",)


def _spec(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(arch: ArchSpec, shape: ShapeSpec, *,
                n_workers: int = 1) -> dict[str, torch.Tensor]:
    """``meta`` tensors for the *data inputs* of one (arch x shape) cell.

    Training batches carry the leading worker axis ``[W, B/W, ...]``;
    serving requests do not (serving uses one synchronized replica).
    """
    d = arch.make_model().cfg.d_model
    i32, bf16 = torch.int32, torch.bfloat16
    s, b = shape.seq_len, shape.global_batch
    nf = arch.n_frontend_tokens
    text = s - nf if arch.frontend == "vision" else s

    if shape.kind == "train":
        w = n_workers
        if b % max(w, 1):
            raise ValueError(f"global_batch {b} not divisible by W={w}")
        lead = (w, b // w)
    elif shape.kind == "prefill":
        lead = (b,)
    else:
        # decode: one new token against a seq_len-deep cache
        return {"token": _spec((b, 1), i32), "pos": _spec((b,), i32)}

    spec = {"tokens": _spec((*lead, text), i32)}
    if shape.kind == "train":
        spec["labels"] = _spec((*lead, text), i32)
    if arch.frontend == "vision":
        spec["embeds"] = _spec((*lead, nf, d), bf16)
    if arch.frontend == "audio":
        spec["frames"] = _spec((*lead, nf, d), bf16)
    return spec
