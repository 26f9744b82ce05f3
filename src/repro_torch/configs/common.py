"""ArchSpec — how one architecture plugs into the port (framework-free
subset of ``repro.configs.common``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

__all__ = ["ArchSpec"]


@dataclass(frozen=True)
class ArchSpec:
    """One selectable ``--arch``: the full published config and a reduced
    config of the same family."""

    arch_id: str
    family: str                               # dense|vlm|ssm|hybrid|moe|audio
    make_model: Callable[[], Any]             # full published config
    make_smoke: Callable[[], Any]             # reduced same-family config
    frontend: str | None = None               # "vision" | "audio"
    notes: str = ""
