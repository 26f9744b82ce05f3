"""Optimizers on worker-stacked parameter trees.

Counterpart of ``repro.optim.optimizers``: sgd, momentum, adam, adamw and
adafactor with the same :class:`OptConfig`, warmup-cosine schedule and
global-norm clip.  Updates are elementwise over leaves, so the same code
serves plain and worker-stacked trees.

Two quirks of the reference are kept on purpose (ROADMAP.md C2):

* :func:`_clip` takes ONE global norm over the whole tree it is given —
  for the worker-stacked tree that is a norm across all W workers, not
  one per worker;
* ``make_optimizer("adam", weight_decay=x)`` ignores ``x`` (only the
  decoupled ``adamw`` applies weight decay).

Differences of the port: ``update`` writes parameters and optimizer state
**in place** (and returns them), and ``adam`` / ``adamw`` run through the
fused AdamW kernel (:mod:`repro_torch.kernels.fused_adam_sync`): on CUDA
tensors one norm pass over the gradients as they are (bfloat16 from a
plain step, float32 from accumulated microbatches) writes the clip's
scale on the device, then one launch a leaf applies it as it reads
``g``, so no float32 copy of the gradients is made; on the CPU their
plain versions, the reference's arithmetic bit for bit.  The learning
rate, the step, the clip's scale and the kernel's ``[6]`` hyperparameter
tensor stay on the device, so an update reads nothing back to the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from ..kernels.fused_adam_sync import (clip_partials, clip_scale,
                                      fused_adamw)
from ..kernels.fused_adam_sync.ref import clip_scale_ref, global_norm_ref
from ..tree import tree_leaves, tree_map

__all__ = ["OptConfig", "Optimizer", "make_optimizer", "lr_schedule"]

Tree = Any


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"                 # sgd | momentum | adam | adamw | adafactor
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # adafactor
    factored_min_dim: int = 8
    decay_rate: float = 0.8


def lr_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_ratio * lr`` (a float32
    tensor on ``step``'s device)."""
    step = step.float()
    warm = torch.clamp((step + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * frac


def _global_norm(tree: Tree) -> torch.Tensor:
    return global_norm_ref(tree_leaves(tree))


def _clip(grads: Tree, max_norm: float) -> Tree:
    scale = clip_scale_ref(tree_leaves(grads), max_norm)
    return tree_map(lambda x: x.float() * scale, grads)


def _f32_grads(grads: Tree, cfg: OptConfig) -> Tree:
    return _clip(grads, cfg.grad_clip) if cfg.grad_clip else \
        tree_map(lambda x: x.float(), grads)


class Optimizer(NamedTuple):
    cfg: OptConfig
    init: Any                  # params -> state
    update: Any                # (grads, state, params, step) -> (params, state)


def _zeros_f32(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros(x.shape, dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# SGD / momentum
# ---------------------------------------------------------------------------

def _make_sgd(cfg: OptConfig, nesterov_momentum: bool) -> Optimizer:
    def init(params):
        if not nesterov_momentum:
            return {}
        return {"m": tree_map(_zeros_f32, params)}

    def update(grads, state, params, step):
        lr = lr_schedule(cfg, step)
        g = _clip(grads, cfg.grad_clip) if cfg.grad_clip else grads
        if not nesterov_momentum:
            tree_map(lambda p, gg: p.copy_(p.float() - lr * gg.float()),
                     params, g)
            return params, state

        def upd(p, m, gg):
            m.copy_(cfg.momentum * m + gg)
            p.copy_(p.float() - lr * m)

        tree_map(upd, params, state["m"], g)
        return params, state

    return Optimizer(cfg, init, update)


# ---------------------------------------------------------------------------
# Adam / AdamW (the fused AdamW kernel)
# ---------------------------------------------------------------------------

def _make_adam(cfg: OptConfig, decoupled_wd: bool) -> Optimizer:
    # adam's weight_decay is ignored, as in the reference (ROADMAP.md C2)
    wd = cfg.weight_decay if decoupled_wd else 0.0
    consts: dict[torch.device, torch.Tensor] = {}
    # the norm kernel's partials and scale, one buffer per device and
    # tree size, made once: a captured period keeps reading it
    scratch: dict[tuple, torch.Tensor] = {}

    def init(params):
        return {"m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params)}

    def hyper(step: torch.Tensor) -> torch.Tensor:
        """``[lr, beta1, beta2, eps, wd, step + 1]`` on the device, with
        the constant middle made once per device."""
        dev = step.device
        if dev not in consts:
            consts[dev] = torch.tensor([cfg.beta1, cfg.beta2, cfg.eps, wd],
                                       dtype=torch.float32, device=dev)
        lr = lr_schedule(cfg, step).reshape(1)
        t = (step.float() + 1.0).reshape(1)
        return torch.cat([lr, consts[dev], t])

    def clip_buffer(gs: list) -> torch.Tensor | None:
        if not gs[0].is_cuda:
            return None
        key = (gs[0].device, clip_partials(gs) + 2)
        if key not in scratch:
            scratch[key] = torch.empty(key[1], dtype=torch.float32,
                                       device=key[0])
        return scratch[key]

    def update(grads, state, params, step):
        h = hyper(step)
        gs = [g.contiguous() for g in tree_leaves(grads)]
        scale = clip_scale(gs, cfg.grad_clip, clip_buffer(gs)) \
            if cfg.grad_clip else None
        for p, g, m, v in zip(tree_leaves(params), gs,
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"]), strict=True):
            fused_adamw(p, g, m, v, h, scale=scale)
        return params, state

    return Optimizer(cfg, init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment over the trailing two axes)
# ---------------------------------------------------------------------------

def _factored(x: torch.Tensor, min_dim: int) -> bool:
    return x.dim() >= 2 and x.shape[-1] >= min_dim \
        and x.shape[-2] >= min_dim


def _make_adafactor(cfg: OptConfig) -> Optimizer:
    def init(params):
        def one(x):
            if _factored(x, cfg.factored_min_dim):
                return {
                    "vr": torch.zeros(x.shape[:-1], dtype=torch.float32,
                                      device=x.device),            # row
                    "vc": torch.zeros(x.shape[:-2] + x.shape[-1:],
                                      dtype=torch.float32,
                                      device=x.device),            # col
                }
            return {"v": _zeros_f32(x)}

        def walk(tree):
            if isinstance(tree, dict):
                return {k: walk(v) for k, v in tree.items()}
            return one(tree)

        return {"v": walk(params),
                "m": tree_map(_zeros_f32, params) if cfg.beta1 else None}

    def update(grads, state, params, step):
        lr = lr_schedule(cfg, step)
        t = step.float() + 1.0
        beta2t = 1.0 - t ** (-cfg.decay_rate)
        g = _f32_grads(grads, cfg)

        def upd(p, gg, v, m):
            g2 = gg * gg + 1e-30
            if "vr" in v:
                vr = beta2t * v["vr"] + (1 - beta2t) * g2.mean(-1)
                vc = beta2t * v["vc"] + (1 - beta2t) * g2.mean(-2)
                rms_r = vr / vr.mean(-1, keepdim=True)
                precond = gg / (torch.sqrt(rms_r)[..., None]
                                * torch.sqrt(vc)[..., None, :] + cfg.eps)
                v["vr"].copy_(vr)
                v["vc"].copy_(vc)
            else:
                vf = beta2t * v["v"] + (1 - beta2t) * g2
                precond = gg / (torch.sqrt(vf) + cfg.eps)
                v["v"].copy_(vf)
            # update clipping (Adafactor's RMS-1 rule)
            rms = torch.sqrt((precond * precond).mean() + 1e-30)
            precond = precond / torch.clamp(rms, min=1.0)
            if m is not None:
                m.copy_(cfg.beta1 * m + (1 - cfg.beta1) * precond)
                precond = m
            pf = p.float()
            if cfg.weight_decay:
                pf = pf * (1.0 - lr * cfg.weight_decay)
            p.copy_(pf - lr * precond)

        def walk(p, gg, v, m):
            if isinstance(p, dict):
                for k in p:
                    walk(p[k], gg[k], v[k], None if m is None else m[k])
            else:
                upd(p, gg, v, m)

        walk(params, g, state["v"], state["m"])
        return params, state

    return Optimizer(cfg, init, update)


def make_optimizer(name: str, **kw) -> Optimizer:
    cfg = OptConfig(name=name, **kw)
    if name == "sgd":
        return _make_sgd(cfg, nesterov_momentum=False)
    if name == "momentum":
        return _make_sgd(cfg, nesterov_momentum=True)
    if name == "adam":
        return _make_adam(cfg, decoupled_wd=False)
    if name == "adamw":
        return _make_adam(cfg, decoupled_wd=True)
    if name == "adafactor":
        return _make_adafactor(cfg)
    raise ValueError(f"unknown optimizer {name!r}")
