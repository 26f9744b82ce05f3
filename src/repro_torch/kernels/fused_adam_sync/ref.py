"""Plain PyTorch version of the fused AdamW kernel.

Operation for operation the arithmetic of the TPU kernel
(``repro/kernels/fused_adam_sync/kernel.py:_kernel``) and of the CUDA
kernel: the six hyperparameters come from a ``[6]`` float32 tensor, so
``1 - b1``, ``1 - b2`` and the bias corrections ``1 - b^t`` are taken in
float32.  The clip's scale is the reference's global norm
(``repro/optim/optimizers.py:_clip``): one ``torch.dot`` a leaf over the
whole tree.  The CPU path of the optimizers runs both; on the card the
tests and ``chip_smoke.py`` hold the kernels against them.
"""

from __future__ import annotations

import torch

__all__ = ["fused_adamw_ref", "adamw_hyper", "adamw_ref",
           "global_norm_ref", "clip_scale_ref"]


def fused_adamw_ref(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    v: torch.Tensor, hyper: torch.Tensor,
                    scale: torch.Tensor | None = None) -> None:
    """One AdamW step on a tensor quartet, **in place**: ``p`` (its own
    dtype), ``m`` and ``v`` (float32) are overwritten; ``g`` (any float
    dtype, taken in float32) is read.  ``hyper = [lr, beta1, beta2, eps,
    weight_decay, step + 1]``; ``scale``, a float32 scalar (0-d or
    ``[1]``), multiplies the float32 ``g`` first (the clip)."""
    lr, b1, b2, eps, wd, t = hyper.to(torch.float32).unbind()
    g = g.float()
    if scale is not None:
        g = g * scale.reshape(())
    m2 = b1 * m + (1.0 - b1) * g
    v2 = b2 * v + (1.0 - b2) * g * g
    upd = (m2 / (1.0 - b1 ** t)) / (torch.sqrt(v2 / (1.0 - b2 ** t)) + eps)
    p2 = p.float() * (1.0 - lr * wd) - lr * upd
    p.copy_(p2)
    m.copy_(m2)
    v.copy_(v2)


def adamw_hyper(lr, step, *, beta1=0.9, beta2=0.999, eps=1e-8,
                weight_decay=0.0, device=None) -> torch.Tensor:
    """The kernels' ``[6]`` float32 operand from the reference's keyword
    hyperparameters (``lr`` and ``step`` numbers or 0-d tensors):
    ``[lr, beta1, beta2, eps, weight_decay, step + 1]``."""
    vals = [torch.as_tensor(x, dtype=torch.float32, device=device)
            for x in (lr, beta1, beta2, eps, weight_decay, step)]
    vals[-1] = vals[-1] + 1.0
    return torch.stack(vals)


def adamw_ref(p, g, m, v, *, lr, beta1=0.9, beta2=0.999, eps=1e-8,
              weight_decay=0.0, step=0):
    """The reference's ``adamw_ref`` signature over
    :func:`fused_adamw_ref`: returns new ``(p, m, v)`` (``p`` in its own
    dtype, ``m`` and ``v`` float32) and leaves its arguments as they
    are.  ``1 - beta`` is taken in float32 from the ``[6]`` operand, as
    the kernels take it (ROADMAP C5: 1.3e-5 relative in ``v``)."""
    p2, m2, v2 = p.clone(), m.float().clone(), v.float().clone()
    fused_adamw_ref(p2, g, m2, v2, adamw_hyper(
        lr, step, beta1=beta1, beta2=beta2, eps=eps,
        weight_decay=weight_decay, device=p.device))
    return p2, m2, v2


def global_norm_ref(leaves) -> torch.Tensor:
    """The 2-norm of every leaf together, in float32: one ``torch.dot`` a
    leaf, summed in order."""
    total = 0
    for x in leaves:
        xf = x.float().reshape(-1)
        total = total + torch.dot(xf, xf)
    return torch.sqrt(total)


def clip_scale_ref(leaves, max_norm: float) -> torch.Tensor:
    """The global-norm clip's scale, ``min(max_norm / (norm + 1e-9), 1)``
    as a 0-d float32 tensor."""
    return torch.clamp(max_norm / (global_norm_ref(leaves) + 1e-9), max=1.0)
