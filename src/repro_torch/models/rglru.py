"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks + local MQA.

Counterpart of ``repro.models.rglru`` (arXiv:2402.19427).  The layers
follow the pattern (rec, rec, attn), each sub-block followed by a GeGLU
MLP: ``n_layers // 3`` stacked **superblocks** ``blocks.sub{0,1,2}``
(``[n_super, ...]``) plus a ``tail`` stack of the remaining recurrent
layers (``[n_tail, ...]``).  A superblock is one DreamDDP unit, the
heterogeneous-cost case of the planner.

The model is functional, as :mod:`repro_torch.models.transformer`: it
holds its config, every method takes the parameter dict in the
reference layout, and ``lax.scan`` over superblocks becomes a Python
loop.  ``lam`` stays float32 in a bfloat16 model; the gates and the
recurrence run in float32, as the reference's.

* **The recurrence** ``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)``
  runs over a sequence as :func:`rg_lru_scan`, a log-depth doubling scan
  with the reference's combine (``ceil(log2 L)`` elementwise passes,
  autograd through plain operations), and as an O(1) state update in
  decode.  No Pallas kernel stands behind it in the reference, so none
  does here.
* **Attention** is local (``window``) MQA.  ``apply`` and the training
  ``loss`` run the plain
  :func:`~repro_torch.models.layers.gqa_attention`, as the reference
  does; prefill runs the flash kernel (queries and keys from position
  0, which holds because prefill is exact: ``kv_position_indexed`` is
  False); decode runs the paged kernel over each lane's ring of
  ``window`` keys seen as pages (:meth:`RGLM.decode_step`).

The cache is the reference's: per superblock sub-block ``(conv [n_super,
slots, conv_width - 1, lru] in the model dtype, h [n_super, slots, lru]
float32)`` or the attention ring ``{"k", "v": [n_super, slots, window,
n_kv, hd], "pos": [n_super, slots, window] int32}`` (``-10**9`` where
empty), and ``tail`` as the recurrent pair ``[n_tail, ...]``.  Prefill
and decode write it **in place** and return it.  Decode writes each
lane's key at its own ring slot ``pos % window``, where the reference
writes every lane at ``pos[0]`` (its engine vmaps one-lane steps, which
is the same thing; ROADMAP.md C5).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.partial_sync import UnitEntry, UnitLayout
from ..kernels.flash_attention import flash_attention
from ..kernels.paged_attention import paged_attention
from ..kernels.paged_attention.ops import launch_scratch
from .layers import (apply_rope, dense, dense_init, gqa_attention, norm_init,
                     normal, param_shapes, rms_norm, rope_freqs, softmax_xent,
                     widest_dim_specs)

__all__ = ["RGConfig", "RGLM", "rg_lru_scan"]

Tree = Any

_C = 8.0            # RG-LRU temperature
_RING_PAGE = 16     # keys a page of the ring-as-pages decode view (at most)


@dataclass(frozen=True)
class RGConfig:
    name: str
    n_layers: int                     # total temporal layers (38)
    d_model: int
    n_heads: int
    n_kv_heads: int                   # 1 (MQA)
    d_ff: int
    vocab: int
    lru_width: int | None = None
    head_dim: int | None = None
    window: int = 2048
    conv_width: int = 4
    pattern: tuple[str, ...] = ("rec", "rec", "attn")
    rope_theta: float = 1e4
    param_dtype: str = "bfloat16"
    remat: bool = True
    tie_embeddings: bool = True

    @property
    def lru(self) -> int:
        return self.lru_width or self.d_model

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def n_super(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def n_tail(self) -> int:
        return self.n_layers % len(self.pattern)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _block_diag(p: Tree, x: torch.Tensor) -> torch.Tensor:
    """Block-diagonal linear: w ``[nb, c, c]``, x ``[..., nb*c]``."""
    nb, c, _ = p["w"].shape
    xs = x.reshape(*x.shape[:-1], nb, c)
    y = torch.einsum("...nc,ncd->...nd", xs, p["w"]).reshape(x.shape)
    return y + p["b"]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))   # jax.nn.softplus


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")             # jax.nn.gelu's default


def rg_lru_scan(log_a: torch.Tensor, bt: torch.Tensor,
                h0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """First-order recurrence ``h_t = exp(log_a_t) h_{t-1} + b_t`` over
    axis 1.

    Returns (all h ``[B, L, D]``, final h ``[B, D]``).  ``h0`` seeds the
    recurrence, folded into step 0 as the reference folds it.  A
    Hillis-Steele doubling scan: pass ``d`` combines each step with the
    one ``d`` before it by the reference's ``(a1 + a2, exp(a2) b1 +
    b2)``, so ``ceil(log2 L)`` passes of elementwise work, with no
    per-step loop and no operation autograd cannot follow."""
    if h0 is not None:
        bt = torch.cat([bt[:, :1] + torch.exp(log_a[:, :1]) * h0[:, None],
                        bt[:, 1:]], 1)
    a, b = log_a, bt
    d = 1
    while d < a.shape[1]:
        b = torch.cat([b[:, :d], torch.exp(a[:, d:]) * b[:, :-d] + b[:, d:]],
                      1)
        a = torch.cat([a[:, :d], a[:, :-d] + a[:, d:]], 1)
        d *= 2
    return b, b[:, -1]


def _gates(p: Tree, x: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(log a, input gate) in float32."""
    r = torch.sigmoid(_block_diag(p["r_gate"], x).float())
    i = torch.sigmoid(_block_diag(p["i_gate"], x).float())
    return -_C * _softplus(p["lam"].float()) * r, i


def _rg_lru_apply(p: Tree, x: torch.Tensor, h0=None):
    """x ``[B, L, lru]`` -> (y, h_final float32).  Gates + gated
    recurrence."""
    log_a, i = _gates(p, x)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * i * x.float()
    hs, h_fin = rg_lru_scan(log_a, gated, h0)
    return hs.to(x.dtype), h_fin


def _rg_lru_step(p: Tree, x: torch.Tensor, h: torch.Tensor):
    """One-token step.  x ``[B, lru]``, h ``[B, lru]`` (float32)."""
    log_a, i = _gates(p, x)
    a = torch.exp(log_a)
    h_new = a * h + torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) \
        * i * x.float()
    return h_new.to(x.dtype), h_new


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def _layer(tree: Tree, i: int) -> Tree:
    """Layer ``i`` of a stacked group (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


class RGLM:
    """Functional Griffin LM (init / apply / loss / prefill / decode on a
    contiguous cache of recurrent states and attention rings; unit
    layout and analytic costs)."""

    # LRU states and attention ring buffers fold pad steps in, so
    # right-padded (chunked) prefill would corrupt them: exact prefill only
    kv_position_indexed = False

    def __init__(self, cfg: RGConfig):
        self.cfg = cfg
        # (lanes, device) -> the ring-as-pages block table (a constant)
        self._ring_tables: dict[tuple[int, str], torch.Tensor] = {}

    # ------------------------------------------------------------------ init
    def _mlp_init(self, g: torch.Generator, stack: tuple) -> Tree:
        cfg = self.cfg
        dt, d, f = cfg.dtype, cfg.d_model, cfg.d_ff
        return {"gate": dense_init(g, d, f, dtype=dt, stack=stack),
                "up": dense_init(g, d, f, dtype=dt, stack=stack),
                "down": dense_init(g, f, d, dtype=dt, scale=f ** -0.5,
                                   stack=stack)}

    def _rec_init(self, g: torch.Generator, stack: tuple) -> Tree:
        cfg = self.cfg
        dt, d, lru, dev = cfg.dtype, cfg.d_model, cfg.lru, g.device
        nb = cfg.n_heads
        c = lru // nb

        def gate():
            return {"w": normal(g, (*stack, nb, c, c), c ** -0.5, dt),
                    "b": torch.zeros((*stack, lru), dtype=dt, device=dev)}

        lam = torch.linspace(0.9, 4.0, lru, dtype=torch.float32, device=dev)
        return {
            "ln": norm_init(d, dtype=dt, stack=stack, device=dev),
            "in_x": dense_init(g, d, lru, dtype=dt, stack=stack),
            "in_gate": dense_init(g, d, lru, dtype=dt, stack=stack),
            "conv": normal(g, (*stack, cfg.conv_width, lru),
                           cfg.conv_width ** -0.5, dt),
            "conv_bias": torch.zeros((*stack, lru), dtype=dt, device=dev),
            "r_gate": gate(), "i_gate": gate(),
            "lam": lam.expand(*stack, lru).clone(),
            "out": dense_init(g, lru, d, dtype=dt, scale=lru ** -0.5,
                              stack=stack),
            "mlp": self._mlp_init(g, stack),
            "ln_mlp": norm_init(d, dtype=dt, stack=stack, device=dev),
        }

    def _attn_init(self, g: torch.Generator, stack: tuple) -> Tree:
        cfg = self.cfg
        dt, d, hd, dev = cfg.dtype, cfg.d_model, cfg.hd, g.device
        nq = cfg.n_heads * hd
        return {
            "ln": norm_init(d, dtype=dt, stack=stack, device=dev),
            "wq": dense_init(g, d, nq, dtype=dt, stack=stack),
            "wk": dense_init(g, d, cfg.n_kv_heads * hd, dtype=dt,
                             stack=stack),
            "wv": dense_init(g, d, cfg.n_kv_heads * hd, dtype=dt,
                             stack=stack),
            "wo": dense_init(g, nq, d, dtype=dt, scale=nq ** -0.5,
                             stack=stack),
            "mlp": self._mlp_init(g, stack),
            "ln_mlp": norm_init(d, dtype=dt, stack=stack, device=dev),
        }

    def init(self, generator: torch.Generator) -> Tree:
        """Random parameters on ``generator``'s device, in the reference
        layout, scales and dtypes (the draws differ from JAX's)."""
        cfg = self.cfg
        g = generator
        params: dict = {"embed": {"table": normal(
            g, (cfg.vocab, cfg.d_model), 1.0, cfg.dtype)}}
        stack = (cfg.n_super,)
        params["blocks"] = {
            f"sub{j}": (self._rec_init(g, stack) if kind == "rec"
                        else self._attn_init(g, stack))
            for j, kind in enumerate(cfg.pattern)}
        if cfg.n_tail:
            params["tail"] = self._rec_init(g, (cfg.n_tail,))
        params["head"] = {"norm": norm_init(cfg.d_model, dtype=cfg.dtype,
                                            device=g.device)}
        return params

    def param_specs(self) -> Tree:
        """Logical-axis tree mirroring :meth:`init`'s output (the
        reference's structure-derived rule: a stacked leaf shards its
        widest trailing dim over ``heads``)."""
        specs = widest_dim_specs(param_shapes(self), 2)
        specs["embed"] = {"table": ("vocab", None)}
        specs["head"] = {"norm": {"scale": (None,)}}
        return specs

    # -------------------------------------------------------- sub-blocks
    def _mlp(self, p, x):
        return dense(p["down"], _gelu(dense(p["gate"], x)) * dense(p["up"], x))

    def _conv_full(self, p, u):
        """Causal depthwise conv over time.  u ``[B, L, lru]``."""
        w = p["conv"]
        width = w.shape[0]
        pad = F.pad(u, (0, 0, width - 1, 0))
        return sum(pad[:, i:i + u.shape[1]] * w[i] for i in range(width)) \
            + p["conv_bias"]

    def _rec_in(self, p, x):
        """(gate, conv input u) of a recurrent sub-block."""
        xin = rms_norm(p["ln"], x)
        return _gelu(dense(p["in_gate"], xin)), dense(p["in_x"], xin)

    def _rec_out(self, p, x, y, gate):
        x = x + dense(p["out"], y * gate)
        return x + self._mlp(p["mlp"], rms_norm(p["ln_mlp"], x))

    def _rec_apply(self, p, x):
        """A recurrent sub-block over a whole sequence (no state)."""
        gate, u = self._rec_in(p, x)
        y, _ = _rg_lru_apply(p, self._conv_full(p, u))
        return self._rec_out(p, x, y, gate)

    def _qkv(self, p, x, positions):
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.hd
        xin = rms_norm(p["ln"], x)
        q = dense(p["wq"], xin).reshape(b, s, cfg.n_heads, hd)
        k = dense(p["wk"], xin).reshape(b, s, cfg.n_kv_heads, hd)
        v = dense(p["wv"], xin).reshape(b, s, cfg.n_kv_heads, hd)
        inv = rope_freqs(hd, cfg.rope_theta, device=x.device)
        return apply_rope(q, positions, inv), apply_rope(k, positions, inv), v

    def _attn_out(self, p, x, att):
        x = x + dense(p["wo"], att.reshape(*x.shape[:2], -1))
        return x + self._mlp(p["mlp"], rms_norm(p["ln_mlp"], x))

    def _attn_apply(self, p, x, positions):
        """An attention sub-block over a whole sequence (no cache)."""
        q, k, v = self._qkv(p, x, positions)
        att = gqa_attention(q, k, v, q_positions=positions,
                            kv_positions=positions, causal=True,
                            window=self.cfg.window)
        return self._attn_out(p, x, att)

    def _super_apply(self, p, x, positions):
        for j, kind in enumerate(self.cfg.pattern):
            sub = p[f"sub{j}"]
            x = self._rec_apply(sub, x) if kind == "rec" \
                else self._attn_apply(sub, x, positions)
        return x

    # ----------------------------------------------------------- model
    def _embed(self, params, tokens):
        return params["embed"]["table"][tokens] * (self.cfg.d_model ** 0.5)

    def _backbone(self, params, tokens, *, remat: bool = False):
        cfg = self.cfg
        x = self._embed(params, tokens)
        b, s = tokens.shape
        positions = torch.arange(s, device=x.device).expand(b, s)

        def run(fn, *args):
            if remat:
                # no RNG state to keep (the model has no dropout), and
                # saving it is not allowed while a CUDA graph captures
                return checkpoint(fn, *args, use_reentrant=False,
                                  preserve_rng_state=False)
            return fn(*args)

        for i in range(cfg.n_super):
            x = run(self._super_apply, _layer(params["blocks"], i), x,
                    positions)
        for i in range(cfg.n_tail):
            x = run(self._rec_apply, _layer(params["tail"], i), x)
        return x

    def _head(self, params, x):
        x = rms_norm(params["head"]["norm"], x)
        return x @ params["embed"]["table"].T

    def apply(self, params, tokens) -> torch.Tensor:
        """Full-sequence forward -> logits ``[b, s, vocab]``."""
        return self._head(params, self._backbone(params, tokens))

    def loss(self, params, batch, *,
             segment_cuts: tuple[int, ...] = ()) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch = {tokens, labels}``,
        float32, each superblock and tail layer recomputed in the
        backward pass under ``remat``; ``segment_cuts`` is accepted for
        the reference's signature and has no effect here (as in the
        dense model)."""
        del segment_cuts
        x = self._backbone(params, batch["tokens"],
                           remat=self.cfg.remat and torch.is_grad_enabled())
        logits = self._head(params, x)
        return softmax_xent(logits[:, :-1], batch["labels"][:, 1:])

    # --------------------------------------------------------------- serving
    def _rec_state0(self, lead: tuple, device) -> tuple:
        cfg = self.cfg
        return (torch.zeros((*lead, cfg.conv_width - 1, cfg.lru),
                            dtype=cfg.dtype, device=device),
                torch.zeros((*lead, cfg.lru), dtype=torch.float32,
                            device=device))

    def _attn_cache0(self, lead: tuple, device) -> Tree:
        cfg = self.cfg
        kv = (*lead, cfg.window, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(kv, dtype=cfg.dtype, device=device),
                "v": torch.zeros(kv, dtype=cfg.dtype, device=device),
                "pos": torch.full((*lead, cfg.window), -10 ** 9,
                                  dtype=torch.int32, device=device)}

    def init_cache(self, batch: int, max_seq: int, *, device) -> Tree:
        """The reference's cache for ``batch`` lanes (fixed size:
        ``max_seq`` unused)."""
        cfg = self.cfg
        del max_seq
        lead = (cfg.n_super, batch)
        cache = {"blocks": {
            f"sub{j}": (self._rec_state0(lead, device) if kind == "rec"
                        else self._attn_cache0(lead, device))
            for j, kind in enumerate(cfg.pattern)}}
        if cfg.n_tail:
            cache["tail"] = self._rec_state0((cfg.n_tail, batch), device)
        return cache

    def prefill(self, params, tokens, cache) -> tuple[torch.Tensor, Tree]:
        """Run the full sequence and capture every decode state in one
        sweep, written into ``cache`` in place (its contents are not
        read): each recurrent layer's last ``conv_width - 1`` conv inputs
        (zero-padded on the left for a shorter prompt) and final h, each
        attention layer's last ``min(s, window)`` keys and values at
        their ring slots ``pos % window`` (the rest empty).  Attention
        runs the flash kernel with the local window.  Returns (last-token
        logits ``[b, 1, vocab]``, cache)."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        b, s = tokens.shape
        w, keep = cfg.window, cfg.conv_width - 1
        positions = torch.arange(s, device=x.device).expand(b, s)
        take = min(s, w)
        tail_pos = torch.arange(s - take, s, device=x.device)
        slots = tail_pos % w

        def capture_rec(p, x, state, i):
            gate, u = self._rec_in(p, x)
            conv, h = state
            window = u[:, -keep:]
            conv[i] = F.pad(window, (0, 0, keep - window.shape[1], 0))
            y, h[i] = _rg_lru_apply(p, self._conv_full(p, u))
            return self._rec_out(p, x, y, gate)

        def capture_attn(p, x, ring, i):
            q, k, v = self._qkv(p, x, positions)
            for name, t in (("k", k), ("v", v)):
                ring[name][i, :, take:] = 0
                ring[name][i, :, slots] = t[:, -take:]
            ring["pos"][i, :, take:] = -10 ** 9
            ring["pos"][i, :, slots] = tail_pos.to(torch.int32)
            att = flash_attention(q, k, v, causal=True, window=w)
            return self._attn_out(p, x, att)

        for i in range(cfg.n_super):
            for j, kind in enumerate(cfg.pattern):
                key = f"sub{j}"
                p = _layer(params["blocks"][key], i)
                x = (capture_rec if kind == "rec" else capture_attn)(
                    p, x, cache["blocks"][key], i)
        for i in range(cfg.n_tail):
            x = capture_rec(_layer(params["tail"], i), x, cache["tail"], i)
        return self._head(params, x[:, -1:]), cache

    @property
    def ring_page(self) -> int:
        """Keys a page of the ring-as-pages view: the largest divisor of
        the window up to 16."""
        return math.gcd(self.cfg.window, _RING_PAGE)

    def ring_table(self, lanes: int, device) -> torch.Tensor:
        """The constant block table of the ring-as-pages view, ``[lanes,
        2 * window / ps]`` int32: lane ``b``'s logical page ``j`` is page
        ``b * (window / ps) + j mod (window / ps)`` of the rings ``[lanes
        * window / ps, ps, n_kv, hd]``.  Built once per (lanes, device)."""
        key = (lanes, str(torch.device(device)))
        table = self._ring_tables.get(key)
        if table is None:
            per = self.cfg.window // self.ring_page
            j = torch.arange(2 * per, device=device)
            lane = torch.arange(lanes, device=device)[:, None]
            table = (lane * per + j % per).to(torch.int32).contiguous()
            self._ring_tables[key] = table
        return table

    def decode_scratch(self, lanes: int, device, max_seq: int | None = None):
        """The paged kernel's split-K scratch for ``lanes``-wide decode
        steps on ``device`` (``None`` when a launch needs none): a
        caller whose launches must keep their addresses (a captured
        CUDA graph) owns it and passes it to every step.  ``max_seq``
        does not enter: the rings are ``window`` keys at any depth."""
        del max_seq
        cfg = self.cfg
        return launch_scratch(lanes, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                              2 * cfg.window // self.ring_page,
                              torch.device(device))

    def decode_step(self, params, cache, token, pos, *, attn_scratch=None
                    ) -> tuple[torch.Tensor, Tree]:
        """One-token step of every lane (``token [b, 1]``, ``pos [b]``:
        each lane at its own position), the cache updated in place.
        Returns (logits ``[b, 1, vocab]``, cache).

        Each lane writes its key and value at its own ring slot ``pos %
        window``; then the paged kernel (its plain version on the CPU)
        reads the rings as pages of ``ps`` keys through
        :meth:`ring_table`, with the window.  Positions ``> pos - window``
        fill distinct ring slots, so reading logical positions ``[pos -
        window + 1, pos]`` through the periodic table is exactly the
        reference's ring attention.  ``kv_len = pos + 1`` is folded into
        ``(window, 2 window]`` by a whole number of windows, which moves
        neither a ring slot nor the window's mask: the table is two rings
        wide, whatever the lane's depth.  ``attn_scratch``: the paged
        kernel's scratch of the caller's own (:meth:`decode_scratch`).
        """
        cfg = self.cfg
        w = cfg.window
        x = self._embed(params, token)
        b = x.shape[0]
        positions = pos[:, None]
        rows = torch.arange(b, device=x.device)
        slot = pos.long() % w
        kv_len = pos.to(torch.int32) + 1
        kv_len = torch.where(kv_len > w, (kv_len - 1) % w + 1 + w, kv_len)
        table = self.ring_table(b, x.device)
        ps = self.ring_page

        def rec(p, x, state, i):
            conv, h = state
            gate, u = self._rec_in(p, x)
            hist = torch.cat([conv[i], u], 1)
            conv[i] = hist[:, 1:]
            u1 = torch.einsum("bwc,wc->bc", hist, p["conv"]) + p["conv_bias"]
            y1, h[i] = _rg_lru_step(p, u1, h[i])
            return self._rec_out(p, x, y1[:, None], gate)

        def attn(p, x, ring, i):
            q, k, v = self._qkv(p, x, positions)
            ring["k"][i, rows, slot] = k[:, 0]
            ring["v"][i, rows, slot] = v[:, 0]
            ring["pos"][i, rows, slot] = pos.to(torch.int32)
            pages = [ring[n][i].view(-1, ps, cfg.n_kv_heads, cfg.hd)
                     for n in ("k", "v")]
            att = paged_attention(q[:, 0], *pages, table, kv_len, window=w,
                                  scratch=attn_scratch)
            return self._attn_out(p, x, att)

        for i in range(cfg.n_super):
            for j, kind in enumerate(cfg.pattern):
                key = f"sub{j}"
                p = _layer(params["blocks"][key], i)
                x = (rec if kind == "rec" else attn)(
                    p, x, cache["blocks"][key], i)
        for i in range(cfg.n_tail):
            x = rec(_layer(params["tail"], i), x, cache["tail"], i)
        return self._head(params, x), cache

    # ------------------------------------------------------------- structure
    def unit_layout(self) -> UnitLayout:
        cfg = self.cfg
        entries = [UnitEntry("embed", "embed", None)]
        entries += [UnitEntry(f"super_{i}", "blocks", i)
                    for i in range(cfg.n_super)]
        entries += [UnitEntry(f"tail_{i}", "tail", i)
                    for i in range(cfg.n_tail)]
        entries.append(UnitEntry("head", "head", None))
        return UnitLayout(tuple(entries))

    def _rec_param_count(self) -> int:
        cfg = self.cfg
        d, lru, nb = cfg.d_model, cfg.lru, cfg.n_heads
        n = d + 2 * d * lru                                  # ln + in projs
        n += cfg.conv_width * lru + lru                      # conv
        n += 2 * (nb * (lru // nb) ** 2 + lru)               # gates
        n += lru                                             # lambda
        n += lru * d                                         # out
        n += d + 3 * d * cfg.d_ff                            # ln_mlp + mlp
        return n

    def _attn_param_count(self) -> int:
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.hd
        n = d + d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) \
            + cfg.n_heads * hd * d
        n += d + 3 * d * cfg.d_ff
        return n

    def _super_param_count(self) -> int:
        return sum(self._rec_param_count() if k == "rec"
                   else self._attn_param_count() for k in self.cfg.pattern)

    def param_count(self) -> int:
        cfg = self.cfg
        return (cfg.vocab * cfg.d_model
                + cfg.n_super * self._super_param_count()
                + cfg.n_tail * self._rec_param_count()
                + cfg.d_model)

    def active_param_count(self) -> int:
        return self.param_count()

    def layer_costs(self, batch: int, seq: int, *,
                    mode: str = "train") -> list[tuple[str, float, float]]:
        """(unit_name, n_params, fwd_flops) per unit — profiler input."""
        cfg = self.cfg
        tokens = batch * (seq if mode == "train" else 1)
        att_len = min(seq, cfg.window)
        out = [("embed", float(cfg.vocab * cfg.d_model),
                2.0 * tokens * cfg.d_model)]
        rec_f = 2.0 * tokens * (2 * cfg.d_model * cfg.lru
                                + 2 * cfg.lru ** 2 / cfg.n_heads
                                + cfg.lru * cfg.d_model
                                + 3 * cfg.d_model * cfg.d_ff)
        attn_f = 2.0 * tokens * (cfg.d_model * cfg.hd
                                 * (cfg.n_heads + 2 * cfg.n_kv_heads)
                                 + cfg.n_heads * cfg.hd * cfg.d_model
                                 + 3 * cfg.d_model * cfg.d_ff) \
            + 2.0 * tokens * att_len * cfg.n_heads * cfg.hd * 2
        sup_f = sum(rec_f if k == "rec" else attn_f for k in cfg.pattern)
        for i in range(cfg.n_super):
            out.append((f"super_{i}", float(self._super_param_count()),
                        sup_f))
        for i in range(cfg.n_tail):
            out.append((f"tail_{i}", float(self._rec_param_count()), rec_f))
        out.append(("head", float(cfg.d_model),
                    2.0 * tokens * cfg.d_model * cfg.vocab))
        return out
