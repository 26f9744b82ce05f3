"""Architecture registry of the port: ``--arch <id>`` -> :class:`ArchSpec`.

Ported: the dense decoders granite-3-2b (served and trained), qwen3-1.7b,
phi4-mini-3.8b and qwen2.5-32b, the MoE decoders qwen3-moe-30b-a3b and
deepseek-v3-671b (MLA and multi-token prediction), mamba2-780m (Mamba-2;
served) and recurrentgemma-9b (the Griffin hybrid; served and trained).
The other architectures of ``repro.configs`` (llava-next-34b,
whisper-medium) follow the model families in ROADMAP.md queue A.
"""

from __future__ import annotations

from . import (deepseek_v3_671b, granite_3_2b, mamba2_780m, phi4_mini_3_8b,
               qwen2_5_32b, qwen3_1_7b, qwen3_moe_30b_a3b, recurrentgemma_9b)
from .common import ArchSpec

_MODULES = (granite_3_2b, phi4_mini_3_8b, qwen2_5_32b, qwen3_1_7b,
            mamba2_780m, qwen3_moe_30b_a3b, deepseek_v3_671b,
            recurrentgemma_9b)

ARCHS: dict[str, ArchSpec] = {m.ARCH.arch_id: m.ARCH for m in _MODULES}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(
            f"arch {arch_id!r} is not ported to repro_torch yet (ported: "
            f"{sorted(ARCHS)}; the rest follow ROADMAP.md queue A item 9)")
    return ARCHS[arch_id]


__all__ = ["ARCHS", "ArchSpec", "get_arch"]
