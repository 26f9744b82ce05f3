"""Mixture-of-Experts feed-forward (token-choice top-k, capacity-based).

Counterpart of ``repro.models.moe``, in plain functions on tensors.  The
reference's dense dispatch is kept as it is: dispatch and combine are
one-hot einsums ``[b, s, e, c]``, and every expert computes on all ``c``
capacity slots of every sequence, whether a token was routed there or
not (an empty slot computes on zeros).  At decode (``s = 1``) the
capacity is ``top_k``, so a tick reads every expert's weights.

Capacity is per sequence, ``c = max(int(s * k / e * capacity_factor),
k)`` (the MaxText/Switch convention), taken from the length the layer
sees: a right-padded prefill bucket counts its pad.  Slots are given in
position-major order (sequence position first, routing rank second), so
a pad at the end never displaces a real token; overflow tokens are
dropped with combine weight 0.

Routing variants: ``router="softmax"`` (softmax over every expert,
renormalised top-k; Qwen3-MoE) and ``router="sigmoid"`` (sigmoid
scores, top-k, renormalised, times ``routed_scale``; DeepSeek-V3's
routing without the bias update), plus ``n_shared`` always-on shared
experts.

One-hots are built by comparing with an ``arange``: a dropped token's
out-of-range slot index ``c`` then gives a zero row, as
``jax.nn.one_hot`` does (``torch.nn.functional.one_hot`` raises on it),
with no host check, so the layer runs inside a CUDA graph capture.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from .layers import dense, normal

__all__ = ["MoEConfig", "moe_init", "moe_specs", "moe_apply",
           "moe_param_count", "moe_active_param_count", "moe_fwd_flops"]

Tree = Any


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden size
    n_shared: int = 0            # always-on shared experts
    capacity_factor: float = 1.25
    router: str = "softmax"      # or "sigmoid"
    routed_scale: float = 1.0    # DeepSeek routed_scaling_factor (2.5 for V3)

    def capacity(self, seq_len: int) -> int:
        c = int(seq_len * self.top_k / self.n_experts * self.capacity_factor)
        return max(c, self.top_k)


def moe_init(gen: torch.Generator, cfg: MoEConfig, d_model: int, *,
             dtype=torch.bfloat16, stack: tuple = ()) -> Tree:
    """Router ``[*stack, d, e]`` (float32), stacked expert SwiGLU weights
    ``gate``/``up`` ``[*stack, e, d, f]`` and ``down`` ``[*stack, e, f,
    d]``, and the shared experts, at the reference's scales."""
    e, f = cfg.n_experts, cfg.d_ff
    s_in, s_out = d_model ** -0.5, f ** -0.5
    p = {
        "router": {"w": normal(gen, (*stack, d_model, e), s_in,
                               torch.float32)},
        "gate": normal(gen, (*stack, e, d_model, f), s_in, dtype),
        "up": normal(gen, (*stack, e, d_model, f), s_in, dtype),
        "down": normal(gen, (*stack, e, f, d_model), s_out, dtype),
    }
    if cfg.n_shared:
        fs = f * cfg.n_shared
        p["shared"] = {
            "gate": {"w": normal(gen, (*stack, d_model, fs), s_in, dtype)},
            "up": {"w": normal(gen, (*stack, d_model, fs), s_in, dtype)},
            "down": {"w": normal(gen, (*stack, fs, d_model), s_out, dtype)},
        }
    return p


def moe_specs(cfg: MoEConfig) -> Tree:
    """Logical axes of :func:`moe_init`'s leaves (one unstacked layer):
    experts over ``expert``, their hidden dim ``ff``."""
    spec = {"router": {"w": (None, None)},
            "gate": ("expert", None, "ff"),
            "up": ("expert", None, "ff"),
            "down": ("expert", "ff", None)}
    if cfg.n_shared:
        spec["shared"] = {"gate": {"w": (None, "ff")},
                          "up": {"w": (None, "ff")},
                          "down": {"w": ("ff", None)}}
    return spec


def _route(cfg: MoEConfig, logits: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing -> (weights ``[b, s, k]`` float32, indices)."""
    if cfg.router == "softmax":
        scores = torch.softmax(logits, dim=-1)
    elif cfg.router == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        raise ValueError(cfg.router)
    # jax.lax.top_k's order: the lower index first on ties (a stable
    # descending sort; torch.topk promises no order among equal scores)
    w, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    w, idx = w[..., :cfg.top_k], idx[..., :cfg.top_k]
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    if cfg.router == "sigmoid":
        w = w * cfg.routed_scale
    return w, idx


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside ``[0, n)`` gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_apply(p: Tree, cfg: MoEConfig, x: torch.Tensor) -> torch.Tensor:
    """x ``[b, s, d]`` -> ``[b, s, d]``: top-k routed + shared experts."""
    b, s, d = x.shape
    e, k, c = cfg.n_experts, cfg.top_k, cfg.capacity(s)

    logits = x.float() @ p["router"]["w"]                     # [b,s,e]
    weights, idx = _route(cfg, logits)                        # [b,s,k]

    # --- capacity assignment (Switch-style, per sequence) -----------------
    onehot = _one_hot(idx, e, torch.int32)                    # [b,s,k,e]
    # priority: sequence position major, then routing rank
    pos = onehot.reshape(b, s * k, e).cumsum(1) - 1           # [b,s*k,e]
    pos_of = (pos.reshape(b, s, k, e) * onehot).sum(-1)       # [b,s,k]
    keep = pos_of < c
    w_kept = weights * keep                                   # dropped -> 0

    # dispatch / combine [b,s,e,c], both in the activation dtype
    slot = _one_hot(torch.where(keep, pos_of, c), c, x.dtype)  # [b,s,k,c]
    hot = onehot.to(x.dtype)
    disp = torch.einsum("bske,bskc->bsec", hot * keep[..., None], slot)
    comb = torch.einsum("bske,bskc->bsec",
                        hot * w_kept[..., None].to(x.dtype), slot)

    # --- expert compute: every expert on its c slots -----------------------
    xe = torch.einsum("bsec,bsd->ebcd", disp, x)              # [e,b,c,d]
    h = F.silu(torch.einsum("ebcd,edf->ebcf", xe, p["gate"])) \
        * torch.einsum("ebcd,edf->ebcf", xe, p["up"])
    ye = torch.einsum("ebcf,efd->ebcd", h, p["down"])         # [e,b,c,d]
    out = torch.einsum("bsec,ebcd->bsd", comb, ye)

    if cfg.n_shared:
        sh = p["shared"]
        hs = F.silu(dense(sh["gate"], x)) * dense(sh["up"], x)
        out = out + dense(sh["down"], hs)
    return out


# ---------------------------------------------------------------------------
# Analytic accounting (profiler / roofline), the reference's formulas
# ---------------------------------------------------------------------------

def moe_param_count(cfg: MoEConfig, d_model: int) -> int:
    n = d_model * cfg.n_experts                      # router
    n += 3 * cfg.n_experts * d_model * cfg.d_ff      # routed experts
    n += 3 * cfg.n_shared * d_model * cfg.d_ff       # shared
    return n


def moe_active_param_count(cfg: MoEConfig, d_model: int) -> int:
    """Per-token active parameters (for MODEL_FLOPS = 6*N_active*D)."""
    n = d_model * cfg.n_experts
    n += 3 * cfg.top_k * d_model * cfg.d_ff
    n += 3 * cfg.n_shared * d_model * cfg.d_ff
    return n


def moe_fwd_flops(cfg: MoEConfig, d_model: int, tokens: int,
                  seq_len: int) -> float:
    """Forward FLOPs actually executed (dispatch and combine included)."""
    c = cfg.capacity(seq_len)
    e = cfg.n_experts
    flops = 2.0 * tokens * d_model * e                       # router
    flops += 2.0 * tokens * e * c * d_model * 2              # dispatch+combine
    eff = tokens / seq_len * e * c                           # slot-tokens
    flops += 2.0 * eff * d_model * cfg.d_ff * 3              # expert SwiGLU
    flops += 2.0 * tokens * d_model * (cfg.n_shared * cfg.d_ff) * 3
    return flops
