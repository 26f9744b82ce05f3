"""The plain reference of an MLA + MoE decoder (Moonlight's DeepSeek-V3
block) in float32, and a DreamDDP period around it.

Written from the published equations (DeepSeek-V3's modelling code as
Moonlight's ``config.json`` sets it up), with the departures the
configuration file lists under ``assumed``:

* attention: the expanded MLA with no query LoRA, ``q = x W_q`` split
  into ``q_nope`` and ``q_rope``; ``[c_kv, k_rope] = x W_dkv``,
  ``c_kv`` RMS-normalised; per head ``k = [c_kv W_uk, rope(k_rope)]``
  (one rope key shared by every head) and ``v = c_kv W_uv``; causal
  softmax at scale ``(qk_nope + qk_rope)^-1/2``; ``W_o``.  Rope rotates
  halves (:func:`perfbench.reference.rope`);
* the expert layer: sigmoid scores of a float32 router over every
  expert, the ``top_k`` largest (``noaux_tc`` with its bias at zero and
  one group), weights renormalised over the chosen and scaled by
  ``routed_scaling_factor``; the held experts' SwiGLU over the tokens
  that chose each of them, one expert at a time, times its weight; a
  choice of an expert held elsewhere adds nothing (the chip's share of
  expert parallelism, as the program computes it); plus the shared
  experts as one SwiGLU;
* layers: pre-norm RMSNorm, the leading dense layers with a SwiGLU MLP,
  an untied head.

It imports nothing of the program and takes nothing the program made:
weights are drawn again from the seed (:mod:`perfbench.moe_weights`),
rows come from the benchmark's generator, the plan is the paper's worked
out again (:mod:`perfbench.moe_plan`).  AdamW, its rate, RMSNorm, rope
and the float8 control are :mod:`perfbench.reference`'s.  Each block, and
each query chunk of its attention, is recomputed in the backward pass so
that one worker's float32 step fits beside the period's state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import moe_plan
from .moe_weights import draw_moe_leaf, moe_leaves
from .reference import adamw, mm, rms_norm, rope, xent

__all__ = ["forward_logits", "moe_layer", "train_reference", "unit_slices",
           "sync"]

Q_CHUNK = 1024


def _attend(q, k, v, lo, quant):
    """Causal attention of queries ``[lo, lo + chunk)``: q ``[b, h, c,
    qk]``, k ``[b, h, s, qk]``, v ``[b, h, s, vd]``."""
    hi = lo + q.shape[2]
    scores = mm(q, k[:, :, :hi].transpose(-1, -2), quant) \
        * q.shape[-1] ** -0.5
    rows = torch.arange(lo, hi, device=q.device)[:, None]
    cols = torch.arange(hi, device=q.device)[None, :]
    scores = scores.masked_fill(cols > rows, float("-inf"))
    return mm(torch.softmax(scores, -1), v[:, :, :hi], quant)


def mla(x: torch.Tensor, p: dict, m: dict, quant) -> torch.Tensor:
    """Expanded MLA without query LoRA on ``x [b, s, d]``."""
    b, s, _ = x.shape
    h, nope, rd, vd = (m["n_heads"], m["qk_nope_dim"], m["qk_rope_dim"],
                       m["v_head_dim"])
    pos = torch.arange(s, device=x.device)
    q = mm(x, p["w_q"], quant).reshape(b, s, h, nope + rd)
    q_nope, q_rope = q.split([nope, rd], -1)
    c_kv, k_rope = mm(x, p["w_dkv"], quant).split([m["kv_lora_rank"], rd],
                                                  -1)
    c_kv = rms_norm(c_kv, p["kv_norm"], m["norm_eps"])
    k_nope = mm(c_kv, p["w_uk"], quant).reshape(b, s, h, nope)
    v = mm(c_kv, p["w_uv"], quant).reshape(b, s, h, vd)
    q = torch.cat([q_nope, rope(q_rope, pos, m["rope_theta"])], -1)
    k_rope = rope(k_rope[:, :, None], pos, m["rope_theta"])
    k = torch.cat([k_nope, k_rope.expand(b, s, h, rd)], -1)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))       # [b, h, s, *]
    parts = []
    for lo in range(0, s, Q_CHUNK):
        qc = q[:, :, lo:lo + Q_CHUNK]
        if torch.is_grad_enabled():
            parts.append(checkpoint(_attend, qc, k, v, lo, quant,
                                    use_reentrant=False))
        else:
            parts.append(_attend(qc, k, v, lo, quant))
    out = torch.cat(parts, 2).transpose(1, 2).reshape(b, s, h * vd)
    return mm(out, p["w_o"], quant)


def swiglu(x, gate, up, down, quant):
    return mm(F.silu(mm(x, gate, quant)) * mm(x, up, quant), down, quant)


def moe_layer(x: torch.Tensor, p: dict, m: dict, quant) -> torch.Tensor:
    """The held experts' share of the routed output plus the shared
    experts, on ``x [b, s, d]``."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    scores = torch.sigmoid(mm(xt, p["router"], quant))      # [T, e]
    top, idx = torch.topk(scores, m["top_k"], dim=-1)
    weight = top / (top.sum(-1, keepdim=True) + 1e-20) * m["routed_scale"]
    first, held = m["experts_held"]
    out = torch.zeros_like(xt)
    for j in range(held):
        chose = idx == first + j                             # [T, k]
        tokens = chose.any(-1).nonzero().squeeze(-1)
        if tokens.numel() == 0:
            continue
        w = (weight * chose).sum(-1)[tokens]
        y = swiglu(xt[tokens], p["gate"][j], p["up"][j], p["down"][j], quant)
        out = out.index_add(0, tokens, y * w[:, None])
    out = out.reshape(b, s, d)
    return out + swiglu(x, p["s_gate"], p["s_up"], p["s_down"], quant)


def _keys(group: str, moe: bool) -> dict:
    a = f"{group}.attn."
    keys = {"ln1": f"{group}.ln1.scale", "ln2": f"{group}.ln2.scale",
            "w_q": a + "w_q", "w_dkv": a + "w_dkv",
            "kv_norm": a + "kv_norm.scale", "w_uk": a + "w_uk",
            "w_uv": a + "w_uv", "w_o": a + "w_o"}
    mlp = f"{group}.mlp."
    if moe:
        keys.update(router=mlp + "router.w", gate=mlp + "gate",
                    up=mlp + "up", down=mlp + "down",
                    s_gate=mlp + "shared.gate.w", s_up=mlp + "shared.up.w",
                    s_down=mlp + "shared.down.w")
    else:
        keys.update(gate=mlp + "gate.w", up=mlp + "up.w",
                    down=mlp + "down.w")
    return keys


def block(x: torch.Tensor, p: dict, m: dict, quant, moe: bool
          ) -> torch.Tensor:
    eps = m["norm_eps"]
    x = x + mla(rms_norm(x, p["ln1"], eps), p, m, quant)
    h = rms_norm(x, p["ln2"], eps)
    if moe:
        return x + moe_layer(h, p, m, quant)
    return x + swiglu(h, p["gate"], p["up"], p["down"], quant)


def layers(m: dict) -> list[tuple[str, int, bool]]:
    """(group, index in the group, is MoE) of every layer in network
    order."""
    nd = m["n_dense_layers"]
    return ([("dense_blocks", i, False) for i in range(nd)]
            + [("blocks", i, True) for i in range(m["n_layers"] - nd)])


def forward_logits(flat: dict, tokens: torch.Tensor, m: dict, quant=None
                   ) -> torch.Tensor:
    """Logits ``[b, s, vocab]`` of ``tokens [b, s]`` with the float32
    weights ``flat`` (dotted paths)."""
    x = flat["embed.table"][tokens]
    for group, i, moe in layers(m):
        p = {k: flat[path][i] for k, path in _keys(group, moe).items()}
        if torch.is_grad_enabled():
            x = checkpoint(block, x, p, m, quant, moe, use_reentrant=False)
        else:
            x = block(x, p, m, quant, moe)
    x = rms_norm(x, flat["head.norm.scale"], m["norm_eps"])
    w = flat["embed.table"].T if m["tie"] else flat["head.out.w"]
    return mm(x, w, quant)


def unit_slices(m: dict, unit: int) -> list[tuple[str, tuple]]:
    """(leaf path, index into the worker-stacked leaf) of one schedulable
    unit in network order: 0 the embedding, then each layer, then the
    head."""
    paths = [p for p, _, _, _ in moe_leaves(m)]
    lay = layers(m)
    if unit == 0:
        return [("embed.table", (slice(None),))]
    if unit <= len(lay):
        group, i, _ = lay[unit - 1]
        return [(p, (slice(None), i)) for p in paths
                if p.startswith(group + ".")]
    if unit == len(lay) + 1:
        return [(p, (slice(None),)) for p in paths if p.startswith("head.")]
    raise ValueError(f"unit {unit} of a {len(lay)}-layer decoder")


def sync(params: dict, m: dict, units) -> None:
    """Average the units over the worker axis in float32, in place."""
    for u in units:
        for path, ix in unit_slices(m, u):
            x = params[path][ix]
            params[path][ix] = x.float().mean(0, keepdim=True).to(
                x.dtype).expand_as(x)


def train_reference(m: dict, job: dict, seed: int, rows, device, *,
                    steps: int | None = None, quant=None,
                    fault: str | None = None) -> dict:
    """As :func:`perfbench.reference.train_reference`, for this model:
    the first ``steps`` (a period by default) DreamDDP steps of
    ``job["workers"]`` workers from the weights of ``seed`` with fresh
    AdamW state, each worker's loss and float32 gradient on its rows,
    one clip by the global norm over every worker, AdamW, then the units
    of the paper's plan averaged.  Returns the mean loss of each step,
    each leaf's norm of the first clipped gradient, and after the period
    each leaf's norm of AdamW's first moment and of the change.
    ``fault``: ``"half_batch"`` or ``"no_sync"``."""
    if job["sync"] != "mean":
        raise ValueError(f"the MoE reference syncs by mean, the job "
                         f"states {job['sync']}")
    W = job["workers"]
    phases = moe_plan.phase_units(m, job, W)
    dtype = getattr(torch, m["dtype"])
    params = {}
    for i, (p, shape, _, _) in enumerate(moe_leaves(m)):
        params[p] = draw_moe_leaf(m, seed, i, device, dtype).expand(
            W, *shape).contiguous()
    p0 = {p: t[0].clone() for p, t in params.items()}
    mom = {p: torch.zeros(t.shape, dtype=torch.float32, device=device)
           for p, t in params.items()}
    vel = {p: torch.zeros_like(t) for p, t in mom.items()}
    losses, grad_norms = [], {}
    for step in range(job["period"] if steps is None else steps):
        toks = rows(step).to(device)
        if fault == "half_batch":
            toks = toks[:, : toks.shape[1] // 2]
        grads = {p: torch.empty_like(t) for p, t in mom.items()}
        step_loss = []
        for k in range(W):
            flat = {p: t[k].float().requires_grad_() for p, t in
                    params.items()}
            loss = xent(forward_logits(flat, toks[k], m, quant), toks[k])
            for p, g in zip(flat, torch.autograd.grad(loss, list(
                    flat.values())), strict=True):
                grads[p][k] = g
            step_loss.append(loss.detach())
            del flat, loss
        losses.append(float(torch.stack(step_loss).mean()))
        total = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        clip = torch.clamp(job["grad_clip"] / (total + 1e-9), max=1.0)
        for p in params:
            g = grads[p].mul_(clip)
            if step == 0:
                grad_norms[p] = float(g.norm())
            adamw(params[p], g, mom[p], vel[p], job, step)
        del grads
        if fault != "no_sync":
            sync(params, m, phases[step])
    change = {p: float((params[p].float() - p0[p].float()).norm())
              for p in params}
    moment = {p: float(t.norm()) for p, t in mom.items()}
    return {"losses": losses, "grad_norms": grad_norms, "moment": moment,
            "change": change, "phase_units": phases}
