"""Plain PyTorch version of the fused AdamW kernel.

Operation for operation the arithmetic of the TPU kernel
(``repro/kernels/fused_adam_sync/kernel.py:_kernel``) and of the CUDA
kernel: the six hyperparameters come from a ``[6]`` float32 tensor, so
``1 - b1``, ``1 - b2`` and the bias corrections ``1 - b^t`` are taken in
float32.  The CPU path of the optimizers runs it; on the card
``chip_smoke.py`` holds the kernel against it.
"""

from __future__ import annotations

import torch

__all__ = ["fused_adamw_ref"]


def fused_adamw_ref(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    v: torch.Tensor, hyper: torch.Tensor) -> None:
    """One AdamW step on a tensor quartet, **in place**: ``p`` (its own
    dtype), ``m`` and ``v`` (float32) are overwritten; ``g`` is read.
    ``hyper = [lr, beta1, beta2, eps, weight_decay, step + 1]``."""
    lr, b1, b2, eps, wd, t = hyper.to(torch.float32).unbind()
    g = g.float()
    m2 = b1 * m + (1.0 - b1) * g
    v2 = b2 * v + (1.0 - b2) * g * g
    upd = (m2 / (1.0 - b1 ** t)) / (torch.sqrt(v2 / (1.0 - b2 ** t)) + eps)
    p2 = p.float() * (1.0 - lr * wd) - lr * upd
    p.copy_(p2)
    m.copy_(m2)
    v.copy_(v2)
