"""Architecture registry of the port: ``--arch <id>`` -> :class:`ArchSpec`.

Ported: granite-3-2b (dense; served and trained) and mamba2-780m
(Mamba-2; served).  The other architectures of ``repro.configs`` follow
the model families in ROADMAP.md queue A.
"""

from __future__ import annotations

from . import granite_3_2b, mamba2_780m
from .common import ArchSpec

ARCHS: dict[str, ArchSpec] = {a.arch_id: a for a in (granite_3_2b.ARCH,
                                                     mamba2_780m.ARCH)}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(
            f"arch {arch_id!r} is not ported to repro_torch yet (ported: "
            f"{sorted(ARCHS)}; the rest follow ROADMAP.md queue A item 9)")
    return ARCHS[arch_id]


__all__ = ["ARCHS", "ArchSpec", "get_arch"]
