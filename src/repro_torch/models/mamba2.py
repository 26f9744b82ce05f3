"""Mamba-2 (state-space duality / SSD) language model.

Counterpart of ``repro.models.mamba2``: the chunked SSD forward of
arXiv:2405.21060 (quadratic attention-like work inside chunks, a linear
recurrence across chunk states) and the O(1)-state recurrent decode.
``in_proj`` emits ``[z, x, B, C, dt]``; a causal depthwise conv (width
4) runs over ``[x, B, C]``; the SSD core uses a per-head scalar decay;
the output is gated-RMSNormed and projected back.

The model is functional, as :mod:`repro_torch.models.transformer`: it
holds its config, every method takes the parameter dict in the
reference layout (``embed`` / ``blocks`` stacked ``[n_layers, ...]`` /
``head``), and ``lax.scan`` over layers or chunks becomes a Python loop.
Dtypes promote as jnp promotes them (bfloat16 with float32 gives
float32), with the casts made explicit where torch would refuse mixed
operands, so bfloat16 rounds where the reference rounds.

The intra-chunk part of the SSD (``y_diag`` and the chunk states) goes
through :func:`repro_torch.kernels.ssd_scan.ssd_chunk_grouped` whenever
no gradient is needed: the CUDA kernel on the card, its plain version on
the CPU.  It reads the model's ``[B, L, H, P]`` and ``[B, L, G, N]``
tensors by stride, B and C once per group; that path's inter-chunk term
contracts C per group too, so nothing is repeated per head.  The kernel
keeps ``L`` and the state decay in float32, where the reference rounds
them to the activation dtype (ROADMAP.md C5).  Under autograd (``loss``,
a training ``apply``) the reference's einsum path runs, with its casts.

The cache is the reference's tuple ``(conv_state [L, S, W-1, C],
ssm_state [L, S, H, P, N])``; prefill and decode write it **in place**
and return it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.partial_sync import UnitEntry, UnitLayout
from ..kernels.ssd_scan import ssd_chunk_grouped
from .layers import embed, norm_init, normal, rms_norm, softmax_xent

__all__ = ["Mamba2Config", "Mamba2LM", "ssd_chunked", "ssd_decode_step"]

Tree = Any


@dataclass(frozen=True)
class Mamba2Config:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 128
    param_dtype: str = "float32"
    remat: bool = True
    tie_embeddings: bool = True

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def d_in_proj(self) -> int:
        return 2 * self.d_inner + 2 * self.n_groups * self.d_state \
            + self.n_heads

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


def _promote(*ts: torch.Tensor) -> list[torch.Tensor]:
    """Cast to the common type, as jnp promotes mixed operands."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    return [t.to(dt) for t in ts]


def _einsum(eq: str, *ts: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, *_promote(*ts))


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mul(*_promote(a, b))


def _dense(p: Tree, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(*_promote(x, p["w"]))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))   # jax.nn.softplus


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Lower-triangular segment sums: out[..., i, j] = sum_{j<k<=i} x[..., k]
    (``-inf`` above the diagonal)."""
    t = x.shape[-1]
    c = torch.cumsum(x, -1)
    diff = c[..., :, None] - c[..., None, :]
    mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                init_state: torch.Tensor | None = None, *,
                impl: str | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.

    x ``[B, L, H, P]``, dt ``[B, L, H]`` (post-softplus), a_log ``[H]``,
    b / c ``[B, L, G, N]`` with ``H % G == 0``.  Sequences are padded to
    a chunk multiple with ``dt = 0`` steps (identity state updates).
    Returns (y ``[B, L, H, P]``, final_state ``[B, H, P, N]``).

    ``impl`` picks the intra-chunk path: ``"einsum"`` is the reference's
    arithmetic (and the only one with a backward); ``"cuda"`` / ``"ref"``
    go through :func:`ssd_chunk_grouped`; ``None`` takes the einsum path
    when autograd needs it and :func:`ssd_chunk_grouped` otherwise.
    """
    l_orig = x.shape[1]
    pad = (-l_orig) % chunk
    if pad:
        x, dt, b, c = (F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
                       for a in (x, dt, b, c))
    bs, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = l // chunk
    rep = h // g

    # fold dt into the input; decay per step
    xdt = _mul(x, dt[..., None])                      # [B,L,H,P]
    da = dt * (-torch.exp(a_log.float()))             # [B,L,H]
    cum = torch.cumsum(da.reshape(bs, nc, chunk, h), dim=2)  # [B,nc,cs,H]

    if impl is None:
        impl = "einsum" if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a_log, b, c)) else None
    if impl == "einsum":
        bq = b.reshape(bs, nc, chunk, g, n).repeat_interleave(rep, dim=3)
        cq = c.reshape(bs, nc, chunk, g, n).repeat_interleave(rep, dim=3)
        xq = xdt.reshape(bs, nc, chunk, h, p)
        seg = _segsum(da.reshape(bs, nc, chunk, h).movedim(-1, -2))
        L = torch.exp(seg)                            # [B,nc,H,cs,cs]
        y_diag = _einsum("bzihn,bzjhn,bzhij,bzjhp->bzihp",
                         cq, bq, L.to(cq.dtype), xq)
        decay_states = torch.exp(cum[:, :, -1:, :] - cum)
        states = _einsum("bzjhn,bzjh,bzjhp->bzhpn",
                         bq, decay_states.to(bq.dtype), xq)
    else:
        # the model's own layout, read by stride, B and C once per group
        y_k, states = ssd_chunk_grouped(xdt, b, c, da, chunk, impl=impl)
        y_diag = y_k.reshape(bs, nc, chunk, h, p)

    # inter-chunk recurrence over chunk states, emitting the state
    # *before* each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])         # [B,nc,H]
    carry = (torch.zeros_like(states[:, 0]) if init_state is None
             else init_state.to(states.dtype))
    prev = []
    for z in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, z, :, None, None].to(carry.dtype) \
            + states[:, z]
    prev_states = torch.stack(prev, dim=1)            # [B,nc,H,P,N]

    # inter-chunk contribution
    state_decay = torch.exp(cum)                      # [B,nc,cs,H]
    if impl == "einsum":
        y_off = _einsum("bzihn,bzhpn,bzih->bzihp",
                        cq, prev_states, state_decay.to(cq.dtype))
    else:
        # the same contraction per group: group g's C against its rep
        # heads' states, then the decay
        y_off = _einsum("bzign,bzgrpn->bzigrp",
                        c.reshape(bs, nc, chunk, g, n),
                        prev_states.reshape(bs, nc, g, rep, p, n))
        y_off = _mul(y_off.reshape(bs, nc, chunk, h, p),
                     state_decay.to(c.dtype)[..., None])

    y = (y_diag + y_off).reshape(bs, l, h, p)
    return y[:, :l_orig], carry


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, state: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """O(1) recurrent step.  x ``[B,H,P]``, dt ``[B,H]``, b/c ``[B,G,N]``,
    state ``[B,H,P,N]``."""
    h, g = x.shape[1], b.shape[1]
    rep = h // g
    bq = b.repeat_interleave(rep, dim=1)              # [B,H,N]
    cq = c.repeat_interleave(rep, dim=1)
    da = torch.exp(dt * (-torch.exp(a_log.float())))
    xdt = _mul(x, dt[..., None])
    new_state = state * da[..., None, None].to(state.dtype) \
        + _einsum("bhp,bhn->bhpn", xdt, bq)
    y = _einsum("bhpn,bhn->bhp", new_state, cq)
    return y, new_state


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def _layer(tree: Tree, i: int) -> Tree:
    """Layer ``i`` of the stacked blocks (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


class Mamba2LM:
    """Functional Mamba-2 LM (init / apply / loss / prefill / decode on a
    contiguous state cache; unit layout and analytic costs)."""

    # recurrent state folds every prefill step in (pad steps included), so
    # right-padded (chunked) prefill would corrupt it: exact prefill only
    kv_position_indexed = False

    def __init__(self, cfg: Mamba2Config):
        self.cfg = cfg

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> Tree:
        """Random parameters on ``generator``'s device, in the reference
        layout and scales (the draws differ from JAX's)."""
        cfg = self.cfg
        g, dt, dev = generator, cfg.dtype, generator.device
        d, n = cfg.d_model, cfg.n_layers
        f32 = dict(dtype=torch.float32, device=dev)
        a_log = torch.log(torch.linspace(1.0, 16.0, cfg.n_heads, **f32))
        blocks = {
            "ln": norm_init(d, dtype=dt, stack=(n,), device=dev),
            "in_proj": {"w": normal(g, (n, d, cfg.d_in_proj), d ** -0.5,
                                    dt)},
            "conv": normal(g, (n, cfg.conv_width, cfg.conv_dim),
                           cfg.conv_width ** -0.5, dt),
            "conv_bias": torch.zeros(n, cfg.conv_dim, dtype=dt, device=dev),
            "a_log": a_log.expand(n, -1).clone(),
            "dt_bias": torch.zeros(n, cfg.n_heads, **f32),
            "d_skip": torch.ones(n, cfg.n_heads, **f32),
            "out_norm": norm_init(cfg.d_inner, dtype=dt, stack=(n,),
                                  device=dev),
            "out_proj": {"w": normal(g, (n, cfg.d_inner, d),
                                     cfg.d_inner ** -0.5, dt)},
        }
        head = {"norm": norm_init(d, dtype=dt, device=dev)}
        if not cfg.tie_embeddings:
            head["out"] = {"w": normal(g, (d, cfg.vocab), d ** -0.5, dt)}
        return {"embed": {"table": normal(g, (cfg.vocab, d), 1.0, dt)},
                "blocks": blocks, "head": head}

    # ----------------------------------------------------------------- apply
    def _split_proj(self, zxbcdt: torch.Tensor):
        cfg = self.cfg
        gn = cfg.n_groups * cfg.d_state
        return torch.split(zxbcdt, [cfg.d_inner, cfg.d_inner, gn, gn,
                                    cfg.n_heads], dim=-1)

    def _conv_full(self, p, u: torch.Tensor) -> torch.Tensor:
        """Causal depthwise conv over time.  u ``[B, L, C]``."""
        w = p["conv"]                                  # [W, C]
        width = w.shape[0]
        pad = F.pad(u, (0, 0, width - 1, 0))
        out = sum(pad[:, i:i + u.shape[1]] * w[i] for i in range(width))
        return F.silu(out + p["conv_bias"])

    def _ssm_inputs(self, p, conv_out: torch.Tensor, dt: torch.Tensor):
        cfg = self.cfg
        b, l, _ = conv_out.shape
        gn = cfg.n_groups * cfg.d_state
        xq, bq, cq = torch.split(conv_out, [cfg.d_inner, gn, gn], dim=-1)
        xq = xq.reshape(b, l, cfg.n_heads, cfg.head_dim)
        bq = bq.reshape(b, l, cfg.n_groups, cfg.d_state)
        cq = cq.reshape(b, l, cfg.n_groups, cfg.d_state)
        dt = _softplus(dt.float() + p["dt_bias"])
        return xq, bq, cq, dt

    def _ssm_output(self, p, y, xq, z):
        cfg = self.cfg
        b, l = xq.shape[:2]
        y = y + _mul(xq, p["d_skip"][:, None].to(y.dtype))
        y = y.reshape(b, l, cfg.d_inner)
        y = rms_norm(p["out_norm"], _mul(y, F.silu(z)))
        return _dense(p["out_proj"], y)

    def _block_core(self, p, x: torch.Tensor, conv_state=None,
                    ssm_state=None):
        """Returns (y, new_conv_state, new_ssm_state).  Full-sequence when
        the states are None (train), one step when given (decode, L ==
        1)."""
        cfg = self.cfg
        z, xc, bmat, cmat, dt = self._split_proj(_dense(p["in_proj"], x))
        conv_in = torch.cat([xc, bmat, cmat], -1)
        if conv_state is None:
            conv_out = self._conv_full(p, conv_in)
            new_conv_state = None
        else:
            # roll the conv window: state [B, W-1, C]
            hist = torch.cat([conv_state, conv_in], 1)
            new_conv_state = hist[:, 1:]
            conv_out = F.silu(torch.einsum("bwc,wc->bc", hist, p["conv"])
                              + p["conv_bias"])[:, None]
        xq, bq, cq, dt = self._ssm_inputs(p, conv_out, dt)
        if ssm_state is None:
            y, final = ssd_chunked(xq, dt, p["a_log"], bq, cq, cfg.chunk)
        else:
            y1, final = ssd_decode_step(xq[:, 0], dt[:, 0], p["a_log"],
                                        bq[:, 0], cq[:, 0], ssm_state)
            y = y1[:, None]
        return self._ssm_output(p, y, xq, z), new_conv_state, final

    def _block_apply(self, p, x, conv_state=None, ssm_state=None):
        y, ncs, nss = self._block_core(p, rms_norm(p["ln"], x), conv_state,
                                       ssm_state)
        return x + y.to(x.dtype), ncs, nss

    def _block_train(self, p, x):
        return self._block_apply(p, x)[0]

    def _backbone(self, params, tokens, *, remat: bool = False):
        x = embed(params["embed"], tokens)
        for i in range(self.cfg.n_layers):
            p = _layer(params["blocks"], i)
            if remat:
                x = checkpoint(self._block_train, p, x, use_reentrant=False)
            else:
                x = self._block_train(p, x)
        return x

    def _head(self, params, x):
        x = rms_norm(params["head"]["norm"], x)
        if self.cfg.tie_embeddings:
            return x @ params["embed"]["table"].T
        return _dense(params["head"]["out"], x)

    def apply(self, params, tokens) -> torch.Tensor:
        """Full-sequence forward -> logits ``[b, s, vocab]``."""
        return self._head(params, self._backbone(params, tokens))

    def loss(self, params, batch, *,
             segment_cuts: tuple[int, ...] = ()) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch = {tokens, labels}``,
        float32; ``segment_cuts`` is accepted for the reference's
        signature and has no effect here (as in the dense model)."""
        del segment_cuts
        x = self._backbone(params, batch["tokens"],
                           remat=self.cfg.remat and torch.is_grad_enabled())
        logits = self._head(params, x)
        return softmax_xent(logits[:, :-1], batch["labels"][:, 1:])

    # --------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_seq: int, *, device) -> Tree:
        """``(conv_state [L, batch, W-1, C] in the param dtype, ssm_state
        [L, batch, H, P, N] float32)``; fixed size, ``max_seq`` unused."""
        cfg = self.cfg
        del max_seq
        return (
            torch.zeros(cfg.n_layers, batch, cfg.conv_width - 1,
                        cfg.conv_dim, dtype=cfg.dtype, device=device),
            torch.zeros(cfg.n_layers, batch, cfg.n_heads, cfg.head_dim,
                        cfg.d_state, dtype=torch.float32, device=device))

    def prefill(self, params, tokens, cache) -> tuple[torch.Tensor, Tree]:
        """Run the full sequence and write every layer's final conv window
        and SSM state into ``cache`` (in place; its contents are not
        read).  Returns (last-token logits ``[b, 1, vocab]``, cache).

        The conv window is the last ``W-1`` conv inputs; a prompt shorter
        than that is left-padded with zeros, the causal conv's own
        padding (the reference slices fewer rows there and fails)."""
        cfg = self.cfg
        conv_cache, ssm_cache = cache
        keep = cfg.conv_width - 1
        x = embed(params["embed"], tokens)
        for i in range(cfg.n_layers):
            p = _layer(params["blocks"], i)
            xin = rms_norm(p["ln"], x)
            z, xc, bmat, cmat, dt = self._split_proj(_dense(p["in_proj"],
                                                            xin))
            conv_in = torch.cat([xc, bmat, cmat], -1)
            conv_out = self._conv_full(p, conv_in)
            window = conv_in[:, -keep:]
            conv_cache[i] = F.pad(window, (0, 0, keep - window.shape[1], 0))
            xq, bq, cq, dtp = self._ssm_inputs(p, conv_out, dt)
            y, final = ssd_chunked(xq, dtp, p["a_log"], bq, cq, cfg.chunk)
            ssm_cache[i] = final
            x = x + self._ssm_output(p, y, xq, z).to(x.dtype)
        return self._head(params, x[:, -1:]), cache

    def decode_step(self, params, cache, token, pos
                    ) -> tuple[torch.Tensor, Tree]:
        """One-token step of every lane (``token [b, 1]``; ``pos`` is not
        read: the state carries the position).  Updates ``cache`` in
        place and returns (logits ``[b, 1, vocab]``, cache)."""
        del pos
        conv_cache, ssm_cache = cache
        x = embed(params["embed"], token)
        for i in range(self.cfg.n_layers):
            p = _layer(params["blocks"], i)
            x, ncs, nss = self._block_apply(p, x, conv_cache[i],
                                            ssm_cache[i])
            conv_cache[i] = ncs
            ssm_cache[i] = nss
        return self._head(params, x), cache

    # ------------------------------------------------------------- structure
    def unit_layout(self) -> UnitLayout:
        entries = [UnitEntry("embed", "embed", None)]
        entries += [UnitEntry(f"layer_{i}", "blocks", i)
                    for i in range(self.cfg.n_layers)]
        entries.append(UnitEntry("head", "head", None))
        return UnitLayout(tuple(entries))

    def _block_param_count(self) -> int:
        cfg = self.cfg
        return (cfg.d_model                                     # ln
                + cfg.d_model * cfg.d_in_proj                   # in_proj
                + cfg.conv_width * cfg.conv_dim + cfg.conv_dim  # conv
                + 3 * cfg.n_heads                               # a/dt/D
                + cfg.d_inner                                   # out_norm
                + cfg.d_inner * cfg.d_model)                    # out_proj

    def param_count(self) -> int:
        cfg = self.cfg
        n = cfg.vocab * cfg.d_model + cfg.n_layers * self._block_param_count()
        n += cfg.d_model
        if not cfg.tie_embeddings:
            n += cfg.d_model * cfg.vocab
        return n

    def active_param_count(self) -> int:
        return self.param_count()

    def layer_costs(self, batch: int, seq: int, *,
                    mode: str = "train") -> list[tuple[str, float, float]]:
        """(unit_name, n_params, fwd_flops) per unit — profiler input."""
        cfg = self.cfg
        tokens = batch * (seq if mode == "train" else 1)
        out = [("embed", float(cfg.vocab * cfg.d_model),
                2.0 * tokens * cfg.d_model)]
        per_p = float(self._block_param_count())
        proj = 2.0 * tokens * cfg.d_model * (cfg.d_in_proj + cfg.d_inner)
        if mode == "train":
            ssd = 2.0 * tokens * cfg.chunk * cfg.n_heads * (
                cfg.d_state + cfg.head_dim) \
                + 4.0 * tokens * cfg.n_heads * cfg.head_dim * cfg.d_state
        else:
            ssd = 4.0 * tokens * cfg.n_heads * cfg.head_dim * cfg.d_state
        for i in range(cfg.n_layers):
            out.append((f"layer_{i}", per_p, proj + ssd))
        head_p = float(cfg.d_model + (0 if cfg.tie_embeddings
                                      else cfg.d_model * cfg.vocab))
        out.append(("head", head_p, 2.0 * tokens * cfg.d_model * cfg.vocab))
        return out
