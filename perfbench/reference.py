"""The plain reference: a dense GQA decoder (RoPE, RMSNorm, SwiGLU, tied
or untied head) in float32 with no kernel, cache or batching, and what a
DreamDDP period does around it (the clipped gradient, AdamW with its
warmup-cosine rate, the layer-wise parameter average of the paper's
plan, the int8 wire format with error feedback).

It follows the program's layer equations (``perfbench/models``' config
files list where those depart from the published models).  It imports
nothing of the program and takes nothing the program made: weights are
drawn again from the seed (:mod:`perfbench.weights`), rows come from the
benchmark's own generator.

``quant="fp8"`` is the control: every matrix product takes its operands
rounded to float8 e4m3 with one scale a tensor (the gradient flows as if
the rounding were not there), the step below the bfloat16 the
configurations state.
"""

from __future__ import annotations

import math

import torch

from . import plan
from .weights import dense_leaves, draw_leaf

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FP8_MAX = 448.0                       # largest finite float8 e4m3 value


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the tensor, back
    in ``x``'s dtype; the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor, quant: str | None) -> torch.Tensor:
    if quant == "fp8":
        a, b = fake_fp8(a), fake_fp8(b)
    elif quant is not None:
        raise ValueError(f"unknown quant {quant!r}")
    return a @ b



def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotate-half RoPE over the whole head, ``x [b, s, n, hd]``."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = positions[:, None].float() * inv                 # [s, hd/2]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def attention(q, k, v, quant, q_chunk: int = 1024) -> torch.Tensor:
    """Causal GQA over positions ``[0, s)``: q ``[b, s, nq, hd]``, k and v
    ``[b, s, nkv, hd]``; query head ``h`` reads KV head ``h // (nq /
    nkv)``."""
    b, s, nq, hd = q.shape
    rep = nq // k.shape[2]
    k = k.repeat_interleave(rep, dim=2).transpose(1, 2)    # [b, nq, s, hd]
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    outs = []
    for lo in range(0, s, q_chunk):
        hi = min(s, lo + q_chunk)
        scores = mm(q[:, :, lo:hi], k[:, :, :hi].transpose(-1, -2), quant)
        scores = scores * hd ** -0.5
        rows = torch.arange(lo, hi, device=q.device)[:, None]
        cols = torch.arange(hi, device=q.device)[None, :]
        scores = scores.masked_fill(cols > rows, float("-inf"))
        outs.append(mm(torch.softmax(scores, -1), v[:, :, :hi], quant))
    return torch.cat(outs, 2).transpose(1, 2)


def block(x: torch.Tensor, p: dict, m: dict, quant) -> torch.Tensor:
    """One decoder layer on ``x [b, s, d]`` with layer weights ``p``."""
    b, s, _ = x.shape
    hd, eps = m["head_dim"], m["norm_eps"]
    pos = torch.arange(s, device=x.device)
    h = rms_norm(x, p["ln1"], eps)
    q = mm(h, p["wq"], quant).reshape(b, s, m["n_heads"], hd)
    k = mm(h, p["wk"], quant).reshape(b, s, m["n_kv_heads"], hd)
    v = mm(h, p["wv"], quant).reshape(b, s, m["n_kv_heads"], hd)
    q, k = rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"])
    x = x + mm(attention(q, k, v, quant).reshape(b, s, -1), p["wo"], quant)
    h = rms_norm(x, p["ln2"], eps)
    f = torch.nn.functional.silu(mm(h, p["gate"], quant)) \
        * mm(h, p["up"], quant)
    return x + mm(f, p["down"], quant)


LAYER_KEYS = {"ln1": "blocks.ln1.scale", "wq": "blocks.attn.wq.w",
              "wk": "blocks.attn.wk.w", "wv": "blocks.attn.wv.w",
              "wo": "blocks.attn.wo.w", "ln2": "blocks.ln2.scale",
              "gate": "blocks.mlp.gate.w", "up": "blocks.mlp.up.w",
              "down": "blocks.mlp.down.w"}


def head_logits(x: torch.Tensor, flat: dict, m: dict, quant) -> torch.Tensor:
    x = rms_norm(x, flat["head.norm.scale"], m["norm_eps"])
    w = flat["embed.table"].T if m["tie"] else flat["head.out.w"]
    return mm(x, w, quant)


def forward_logits(flat: dict, tokens: torch.Tensor, m: dict, quant=None
                   ) -> torch.Tensor:
    """Logits ``[b, s, vocab]`` of ``tokens [b, s]`` with the float32
    weights ``flat`` (dotted paths)."""
    x = flat["embed.table"][tokens]
    for i in range(m["n_layers"]):
        x = block(x, {k: flat[path][i] for k, path in LAYER_KEYS.items()},
                  m, quant)
    return head_logits(x, flat, m, quant)


def xent(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy: position ``t`` predicts ``t + 1``."""
    lp = torch.log_softmax(logits[:, :-1].float(), -1)
    return -lp.gather(-1, tokens[:, 1:, None]).mean()


# ---------------------------------------------------------------- serving

@torch.no_grad()
def served_logits(m: dict, seed: int, device, seqs, quant=None
                  ) -> list[torch.Tensor]:
    """For each ``(tokens, positions)`` of ``seqs``, the logits
    ``[len(positions), vocab]`` at ``positions`` of that sequence.  The
    weights are drawn again from ``seed`` in the configuration's dtype
    and each layer is taken to float32 only while it runs."""
    index = {path: i for i, (path, _, _) in enumerate(dense_leaves(m))}

    def leaf(path):
        return draw_leaf(m, seed, index[path], device,
                         getattr(torch, m["dtype"]))

    stacked = {k: leaf(p) for k, p in LAYER_KEYS.items()}
    flat = {p: leaf(p).float() for p in index if not p.startswith("blocks.")}
    out = []
    for tokens, positions in seqs:
        x = flat["embed.table"][torch.tensor(tokens, device=device)[None]]
        for i in range(m["n_layers"]):
            x = block(x, {k: t[i].float() for k, t in stacked.items()}, m,
                      quant)
        rows = x[0, torch.tensor(positions, device=device)]
        out.append(head_logits(rows, flat, m, quant))
    return out


# --------------------------------------------------------------- training

def lr_at(job: dict, step: int, device) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine decay to ``min_lr_ratio *
    lr`` at ``decay_steps``, in float32."""
    s = torch.tensor(float(step), dtype=torch.float32, device=device)
    warm = torch.clamp((s + 1.0) / max(job["warmup_steps"], 1), max=1.0)
    prog = torch.clamp((s - job["warmup_steps"])
                       / max(job["decay_steps"] - job["warmup_steps"], 1),
                       0.0, 1.0)
    frac = job["min_lr_ratio"] + (1.0 - job["min_lr_ratio"]) * 0.5 * (
        1.0 + torch.cos(math.pi * prog))
    return job["lr"] * warm * frac


def adamw(p, g, mo, v, job: dict, step: int) -> None:
    """One AdamW step in float32, in place; ``p`` keeps its dtype."""
    f32 = torch.float32
    b1 = torch.tensor(job["beta1"], dtype=f32, device=p.device)
    b2 = torch.tensor(job["beta2"], dtype=f32, device=p.device)
    t = torch.tensor(step + 1.0, dtype=f32, device=p.device)
    lr = lr_at(job, step, p.device)
    mo.mul_(b1).add_((1.0 - b1) * g)
    v.mul_(b2).add_((1.0 - b2) * g * g)
    upd = (mo / (1.0 - b1 ** t)) / (torch.sqrt(v / (1.0 - b2 ** t))
                                    + job["eps"])
    p.copy_(p.float() * (1.0 - lr * job["weight_decay"]) - lr * upd)


def int8_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` through the int8 wire format: per row of the last axis,
    scale ``max|x| / 127 + 1e-12``, codes rounded half to even and
    clipped to +-127, back to float32."""
    amax = x.abs().amax(-1, keepdim=True)
    scale = amax / torch.full_like(amax, 127.0) + 1e-12
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


def unit_slices(m: dict, unit: int) -> list[tuple[str, tuple]]:
    """(leaf path, index into the worker-stacked leaf) of one schedulable
    unit in network order: 0 the embedding, 1..L the layers, L+1 the
    head."""
    paths = [p for p, _, _ in dense_leaves(m)]
    if unit == 0:
        return [("embed.table", (slice(None),))]
    if unit <= m["n_layers"]:
        return [(p, (slice(None), unit - 1)) for p in paths
                if p.startswith("blocks.")]
    if unit == m["n_layers"] + 1:
        return [(p, (slice(None),)) for p in paths if p.startswith("head.")]
    raise ValueError(f"unit {unit} of a {m['n_layers']}-layer decoder")


def sync(params: dict, ef: dict | None, m: dict, units) -> None:
    """Average the units over the worker axis in float32, in place: as
    they are (``ef is None``) or through the int8 wire format with the
    residual ``ef`` carried to the next sync."""
    for u in units:
        for path, ix in unit_slices(m, u):
            x = params[path][ix]
            if ef is None:
                mean = x.float().mean(0, keepdim=True)
            else:
                xf = x.float() + ef[path][ix]
                deq = int8_rows(xf)
                ef[path][ix] = xf - deq
                mean = deq.mean(0, keepdim=True)
            params[path][ix] = mean.to(x.dtype).expand_as(x)


def train_reference(m: dict, job: dict, seed: int, rows, device, *,
                    steps: int | None = None, quant=None,
                    fault: str | None = None) -> dict:
    """The first ``steps`` (a period, ``job["period"]``, by default)
    DreamDDP steps of ``job["workers"]`` workers from the weights of
    ``seed``, with fresh AdamW state: each worker's loss and float32 gradient on its rows
    (``rows(step)`` -> int64 ``[W, B, S]``), one clip by the global norm
    over every worker, AdamW, then the units the paper's plan
    (:mod:`perfbench.plan`) gives the phase, averaged.  Returns the mean
    loss of each step, each leaf's norm of the clipped gradient of the
    first step, and after the period each leaf's norm of AdamW's first
    moment and of the change, over all workers.  ``fault`` plants a
    fault for the limits' readings: ``"half_batch"`` (the loss and
    gradient of half of each worker's rows), ``"no_sync"`` (the averages
    left out)."""
    W = job["workers"]
    phases = plan.phase_units(m, job, W)
    leaves = dense_leaves(m)
    params = {p: draw_leaf(m, seed, i, device, getattr(torch, m["dtype"]))
              .expand(W, *shape).contiguous()
              for i, (p, shape, _) in enumerate(leaves)}
    p0 = {p: t[0].clone() for p, t in params.items()}
    mom = {p: torch.zeros(t.shape, dtype=torch.float32, device=device)
           for p, t in params.items()}
    vel = {p: torch.zeros_like(t) for p, t in mom.items()}
    ef = None
    if job["sync"] == "int8_ef":
        ef = {p: torch.zeros_like(t) for p, t in mom.items()}
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
            sync(params, ef, m, phases[step])
    change = {p: float((params[p].float() - p0[p].float()).norm())
              for p in params}
    moment = {p: float(t.norm()) for p, t in mom.items()}
    return {"losses": losses, "grad_norms": grad_norms, "moment": moment,
            "change": change, "phase_units": phases}
