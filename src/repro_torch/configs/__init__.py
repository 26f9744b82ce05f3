"""Architecture registry of the port: ``--arch <id>`` -> :class:`ArchSpec`.

All ten architectures of ``repro.configs``: the dense decoders
granite-3-2b (served and trained), qwen3-1.7b, phi4-mini-3.8b and
qwen2.5-32b, the MoE decoders qwen3-moe-30b-a3b and deepseek-v3-671b
(MLA and multi-token prediction), mamba2-780m (Mamba-2; served),
recurrentgemma-9b (the Griffin hybrid; served and trained), and the two
frontends: llava-next-34b (a vision prefix of patch embeddings) and
whisper-medium (an encoder-decoder over audio frames), both served;
and, in :data:`PORT_ARCHS`, the port's own moonlight-16b-a3b (MLA
without query LoRA, a dropless expert layer), trained, which the JAX
package lacks.  The input shapes (:data:`SHAPES`) and :func:`all_cells`
are those of the production dry run (:mod:`repro_torch.launch.dryrun`),
over the ten archs of :data:`ARCHS`.
"""

from __future__ import annotations

from . import (deepseek_v3_671b, granite_3_2b, llava_next_34b, mamba2_780m,
               moonlight_16b_a3b, phi4_mini_3_8b, qwen2_5_32b, qwen3_1_7b,
               qwen3_moe_30b_a3b, recurrentgemma_9b, whisper_medium)
from .common import ArchSpec, batch_specs
from .shapes import SHAPES, ShapeSpec

_MODULES = (granite_3_2b, phi4_mini_3_8b, qwen2_5_32b, qwen3_1_7b,
            llava_next_34b, mamba2_780m, recurrentgemma_9b,
            qwen3_moe_30b_a3b, deepseek_v3_671b, whisper_medium)

ARCHS: dict[str, ArchSpec] = {m.ARCH.arch_id: m.ARCH for m in _MODULES}
# the port's own archs, which the JAX package lacks (no dry-run cell)
PORT_ARCHS: dict[str, ArchSpec] = {
    m.ARCH.arch_id: m.ARCH for m in (moonlight_16b_a3b,)}


def get_arch(arch_id: str) -> ArchSpec:
    spec = ARCHS.get(arch_id) or PORT_ARCHS.get(arch_id)
    if spec is None:
        raise KeyError(f"unknown arch {arch_id!r}; choose from "
                       f"{sorted([*ARCHS, *PORT_ARCHS])}")
    return spec


def all_cells() -> list[tuple[str, str]]:
    """Every runnable (arch_id, shape_name) pair."""
    return [(a.arch_id, s.name) for a in ARCHS.values()
            for s in a.shapes()]


__all__ = ["ARCHS", "PORT_ARCHS", "SHAPES", "ArchSpec", "ShapeSpec",
           "get_arch", "batch_specs", "all_cells"]
