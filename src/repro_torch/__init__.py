"""PyTorch/CUDA port of the DreamDDP reproduction.

``repro_torch`` sits beside the JAX package ``repro`` and keeps its module
names, so each counterpart is easy to find: ``models/{layers,transformer,
moe,mamba2}``, ``kernels/*``, ``configs``, ``core``, ``runtime``,
``serve``, ``api``, ``sim``, ``hier`` and ``launch``.  It imports
``torch`` and numpy only — never ``jax`` and nothing of ``repro``.

Entry points run on the GPU unless the caller passes ``device="cpu"``
(see :func:`resolve_device`).  Float32 matrix products and convolutions
are pinned to full float32 (no TF32) by :mod:`repro_torch.device`, which
the models and the kernels import, so a float32 run on the card is held
to the same arithmetic as the reference.

Importing the package itself loads nothing but the standard library, so
``repro_torch.lint`` runs without torch.
"""

__all__ = ["resolve_device"]


def __getattr__(name: str):
    if name == "resolve_device":
        from .device import resolve_device
        return resolve_device
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
