"""Production mesh descriptions (``repro.launch.mesh`` counterpart).

The reference builds a ``jax.sharding.Mesh`` over 256 or 512 placeholder
devices.  The dry run here needs only the axes and their sizes, so a
mesh is a plain :class:`MeshSpec`: no devices, no process group, no
CUDA context.  A real ``torch.distributed.DeviceMesh`` comes with
multi-GPU training (ROADMAP A12).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = ["MeshSpec", "make_production_mesh", "SINGLE_POD", "MULTI_POD"]

SINGLE_POD = {"shape": (16, 16), "axes": ("data", "model")}
MULTI_POD = {"shape": (2, 16, 16), "axes": ("pod", "data", "model")}


@dataclass(frozen=True)
class MeshSpec:
    """A device mesh as a description: ``sizes[i]`` devices along
    ``axes[i]``."""

    sizes: tuple[int, ...]
    axes: tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axes):
            raise ValueError(f"{len(self.sizes)} sizes for axes {self.axes}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axes, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """16x16 = 256 devices per pod; ``multi_pod`` adds the 2-pod geo
    axis."""
    spec = MULTI_POD if multi_pod else SINGLE_POD
    return MeshSpec(spec["shape"], spec["axes"])
