"""PyTorch/CUDA port of the DreamDDP reproduction.

``repro_torch`` sits beside the JAX package ``repro`` and keeps its module
names, so each counterpart is easy to find: ``models/{layers,transformer,
moe,mamba2}``, ``kernels/*``, ``configs``, ``core``, ``runtime``,
``serve``, ``api``, ``sim``, ``hier`` and ``launch``.  It imports
``torch`` and numpy only — never ``jax`` and nothing of ``repro``.

Entry points run on the GPU unless the caller passes ``device="cpu"``
(see :func:`resolve_device`).  Float32 matrix products and convolutions
are pinned to full float32 (no TF32), so a float32 run on the card is
held to the same arithmetic as the reference.
"""

import torch

from .device import resolve_device

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["resolve_device"]
