"""Architecture registry of the port: ``--arch <id>`` -> :class:`ArchSpec`.

Only the serving slice's model is ported so far; the other architectures
of ``repro.configs`` follow the model families in ROADMAP.md queue A.
"""

from __future__ import annotations

from . import granite_3_2b
from .common import ArchSpec

ARCHS: dict[str, ArchSpec] = {granite_3_2b.ARCH.arch_id: granite_3_2b.ARCH}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(
            f"arch {arch_id!r} is not ported to repro_torch yet (ported: "
            f"{sorted(ARCHS)}; the rest follow ROADMAP.md queue A item 9)")
    return ARCHS[arch_id]


__all__ = ["ARCHS", "ArchSpec", "get_arch"]
