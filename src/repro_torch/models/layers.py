"""Neural-net primitives of the model zoo, as plain functions on tensors.

Counterpart of ``repro.models.layers``.  Parameters are plain dicts of
tensors; the init helpers take a ``torch.Generator`` (whose device is where
the parameters are made) and an optional leading ``stack`` shape for the
layer axis of stacked block groups.  Compute dtype is the parameter
dtype; softmax, norm moments and losses are taken in float32 and cast
back at the same points as the reference, so bfloat16 rounds where the
reference rounds.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from .. import device  # noqa: F401  (no TF32 in float32 products)
from ..tree import tree_map

__all__ = [
    "MetaGenerator", "param_shapes", "normal",
    "dense_spec", "norm_spec", "mlp_spec", "stacked_spec",
    "widest_dim_specs",
    "dense_init", "dense",
    "norm_init", "rms_norm", "layer_norm",
    "embed_init", "embed",
    "rope_freqs", "apply_rope",
    "gqa_attention",
    "mlp_init", "mlp_apply",
    "softmax_xent",
    "count_params",
]

Tree = Any

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------

# float32 elements drawn at once: a larger leaf (a stacked expert or
# feed-forward weight at full width) is drawn one leading slice at a time,
# so the float32 draw never holds more than 4 GiB beside the weights
_DRAW_CHUNK = 1 << 30


class MetaGenerator:
    """Stands in for a ``torch.Generator`` in ``model.init``: the tree
    comes out on the ``meta`` device, shapes and dtypes only, with
    nothing drawn or allocated (the counterpart of
    ``jax.eval_shape(model.init, key)``).  Every draw of the models goes
    through :func:`normal`, which makes an empty tensor for it; every
    other leaf is made on ``device``."""

    device = torch.device("meta")


def param_shapes(model) -> Tree:
    """``model``'s parameter tree as ``meta`` tensors."""
    return model.init(MetaGenerator())


def stacked_spec(spec: Tree) -> Tree:
    """A stacked group's logical axes: ``layers`` before each leaf's."""
    if isinstance(spec, dict):
        return {k: stacked_spec(v) for k, v in spec.items()}
    return ("layers", *spec)


def widest_dim_specs(shapes: Tree, min_dims: int) -> Tree:
    """Structure-derived logical axes (the reference's rule for the
    Griffin and Whisper trees): a stacked leaf of at least ``min_dims``
    dims is ``layers`` first and ``heads`` on its widest later dim
    (the first of equal widths); a smaller one is ``layers`` then
    unsharded."""
    def one(t):
        nd = t.dim()
        if nd < min_dims:
            return ("layers",) + (None,) * (nd - 1) if nd else ()
        dims: list = [None] * nd
        dims[0] = "layers"
        dims[max(range(1, nd), key=lambda i: t.shape[i])] = "heads"
        return tuple(dims)
    return tree_map(one, shapes)


def normal(gen: torch.Generator, shape, scale: float,
           dtype: torch.dtype) -> torch.Tensor:
    """``N(0, scale^2)`` drawn in float32 on ``gen``'s device, then cast
    (an empty ``meta`` tensor for a :class:`MetaGenerator`)."""
    shape = tuple(shape)
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    if len(shape) > 1 and math.prod(shape) > _DRAW_CHUNK:
        out = torch.empty(shape, dtype=dtype, device=gen.device)
        for i in range(shape[0]):
            out[i] = normal(gen, shape[1:], scale, dtype)
        return out
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# Linear / norm / embedding
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, dtype=torch.bfloat16,
               scale: float | None = None, stack: tuple = ()) -> Tree:
    """Weight ``[*stack, d_in, d_out]`` (+ optional zero bias)."""
    scale = (d_in ** -0.5) if scale is None else scale
    p = {"w": normal(gen, (*stack, d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((*stack, d_out), dtype=dtype, device=gen.device)
    return p


def dense_spec(in_axis: str | None = None, out_axis: str | None = None, *,
               bias: bool = False) -> Tree:
    """Logical axes of :func:`dense_init`'s leaves (the reference's
    ``dense_init`` spec)."""
    s = {"w": (in_axis, out_axis)}
    if bias:
        s["b"] = (out_axis,)
    return s


def dense(p: Tree, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def norm_init(d: int, *, dtype=torch.bfloat16, bias: bool = False,
              stack: tuple = (), device=None) -> Tree:
    p = {"scale": torch.ones((*stack, d), dtype=dtype, device=device)}
    if bias:
        p["bias"] = torch.zeros((*stack, d), dtype=dtype, device=device)
    return p


def norm_spec(*, bias: bool = False) -> Tree:
    s = {"scale": (None,)}
    if bias:
        s["bias"] = (None,)
    return s


def rms_norm(p: Tree, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """Moments in float32; ``inv`` is cast to ``x``'s dtype before the
    multiply, as the reference does (``layers.py:92-95``)."""
    ms = x.float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(ms + eps).to(x.dtype)
    return x * inv * p["scale"]


def layer_norm(p: Tree, x: torch.Tensor, *, eps: float = 1e-5
               ) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (x - mu.to(x.dtype)) * torch.rsqrt(var + eps).to(x.dtype) \
        * p["scale"]
    if "bias" in p:
        y = y + p["bias"]
    return y


def embed_init(gen: torch.Generator, vocab: int, d: int, *,
               dtype=torch.bfloat16) -> Tree:
    return {"table": normal(gen, (vocab, d), 1.0, dtype)}


def embed(p: Tree, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies ``[head_dim // 2]`` (float32)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE in float32, cast back at the end.
    ``x: [b, s, n, hd]``, ``positions: [b, s]``."""
    ang = positions[..., None].float() * inv_freq          # [b, s, hd/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, causal / local-window, cached decode)
# ---------------------------------------------------------------------------

def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  q_positions: torch.Tensor | None = None,
                  kv_positions: torch.Tensor | None = None,
                  causal: bool = True,
                  window: int | None = None,
                  kv_valid_len: torch.Tensor | None = None,
                  scale: float | None = None,
                  q_chunk: int | None = 1024) -> torch.Tensor:
    """Grouped-query attention, the plain version.

    q ``[b, sq, n_q, hd]``; k, v ``[b, sk, n_kv, hd]``.  Query head ``h``
    reads KV head ``h // (n_q // n_kv)`` (``repeat_interleave``, as
    ``jnp.repeat`` does).  Scores are float32; masked scores are filled
    with ``-1e30``; the float32 softmax is cast to the activation dtype
    before the PV product.  Queries longer than ``q_chunk`` are processed
    in chunks, so the score tensor peaks at ``[b, n_q, q_chunk, sk]``.
    """
    b, sq, n_q, hd = q.shape
    _, sk, n_kv, _ = k.shape
    if n_q % n_kv:
        raise ValueError(f"n_q={n_q} is not a multiple of n_kv={n_kv}")
    if n_kv != n_q:
        k = k.repeat_interleave(n_q // n_kv, dim=2)
        v = v.repeat_interleave(n_q // n_kv, dim=2)
    scale = (hd ** -0.5) if scale is None else scale
    if q_positions is None:
        q_positions = torch.arange(sq, device=q.device).expand(b, sq)
    if kv_positions is None:
        kv_positions = torch.arange(sk, device=q.device).expand(b, sk)
    kf = k.float()
    kpm = kv_positions[:, None, None, :]

    def attend(qc: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
        scores = torch.einsum("bqnh,bsnh->bnqs", qc.float(), kf) * scale
        qpm = qp[:, None, :, None]
        mask = torch.ones((b, 1, qc.shape[1], sk), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask = mask & (kpm <= qpm)
        if window is not None:
            mask = mask & (kpm > qpm - window)
        if kv_valid_len is not None:
            mask = mask & (kpm < kv_valid_len[:, None, None, None])
        scores = torch.where(mask, scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(qc.dtype)
        return torch.einsum("bnqs,bsnh->bqnh", probs, v)

    if q_chunk is None or sq <= q_chunk:
        return attend(q, q_positions)
    return torch.cat([attend(q[:, i:i + q_chunk], q_positions[:, i:i + q_chunk])
                      for i in range(0, sq, q_chunk)], dim=1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *,
             kind: str = "swiglu", dtype=torch.bfloat16,
             stack: tuple = ()) -> Tree:
    """SwiGLU (gate+up+down) or GELU (up+down) feed-forward."""
    p = {}
    if kind == "swiglu":
        p["gate"] = dense_init(gen, d_model, d_ff, dtype=dtype, stack=stack)
        p["up"] = dense_init(gen, d_model, d_ff, dtype=dtype, stack=stack)
    elif kind == "gelu":
        p["up"] = dense_init(gen, d_model, d_ff, dtype=dtype, stack=stack)
    else:
        raise ValueError(kind)
    p["down"] = dense_init(gen, d_ff, d_model, dtype=dtype,
                           scale=d_ff ** -0.5, stack=stack)
    return p


def mlp_spec(kind: str = "swiglu") -> Tree:
    """Logical axes of :func:`mlp_init`'s leaves: ``ff`` on the hidden
    dim."""
    s = {"up": dense_spec(None, "ff"), "down": dense_spec("ff", None)}
    if kind == "swiglu":
        s = {"gate": dense_spec(None, "ff"), **s}
    return s


def mlp_apply(p: Tree, x: torch.Tensor, *, kind: str = "swiglu"
              ) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(dense(p["gate"], x)) * dense(p["up"], x)
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(dense(p["up"], x), approximate="tanh")
    return dense(p["down"], h)


# ---------------------------------------------------------------------------
# Loss / misc
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 ignore_index: int = -100) -> torch.Tensor:
    """Mean token cross-entropy in float32; ``labels == ignore_index``
    masked."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0)[..., None].long())[..., 0]
    ok = labels != ignore_index
    return ((logz - gold) * ok).sum() / ok.sum().clamp_min(1)


def count_params(tree: Tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return tree.numel()
