"""Whisper-style encoder-decoder backbone (the audio frontend is a stub).

Counterpart of ``repro.models.whisper``.  Requests bring precomputed
mel-frame embeddings ``[b, n_frames, d_model]`` (the output of Whisper's
two conv layers); this module is the transformer: bidirectional encoder
blocks over the frames plus a sinusoid, a bridge LayerNorm, causal
decoder blocks with cross-attention to the encoder output, pre-LayerNorm
(bias, eps 1e-5), tanh-GELU MLPs with biases, learned decoder positions
and a tied head.  ``wk`` has no bias; ``wq``, ``wv`` and ``wo`` have one.
Parameters keep the reference's layout (``embed {table, pos}`` /
``enc_blocks`` / ``bridge`` / ``dec_blocks`` / ``head``, both block
stacks ``[layers, ...]``), so trees carry across with
:mod:`repro_torch.convert`.

``apply`` and the training ``loss`` attend with the plain
:func:`~repro_torch.models.layers.gqa_attention`, as the reference does.
Serving runs the kernels: :meth:`WhisperModel.prefill` encodes the
frames through the flash kernel (non-causal), prefills the decoder's
self-attention through it (causal) and its cross-attention (non-causal,
the prompt against the frames), and stores every layer's cross K/V in
the cache; :meth:`WhisperModel.decode_step` never re-encodes and reads
both lanes through the paged kernel, each contiguous lane seen as pages
through a constant block table (:meth:`WhisperModel.lane_table`): the
self-KV lane with ``kv_len = pos + 1``, the cross lane with ``kv_len =
n_frames``.  On the CPU both wrappers run their plain versions.

Cache: ``{"self": {"k", "v"}, "cross_k", "cross_v"}``, leaves ``[layers,
lanes, depth or n_frames, heads, hd]``, written in place.  The reference
writes every lane's self-KV at ``pos[0]`` (its engine vmaps one-lane
steps); here each lane writes at its own position.  The reference clamps
a decoder position past ``max_positions`` into the table; here so does
the decode step, and the engine refuses a request that would need one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.partial_sync import UnitEntry, UnitLayout
from ..device import sm_count
from ..kernels.flash_attention import flash_attention
from ..kernels.paged_attention import paged_attention
from ..kernels.paged_attention.ops import launch_scratch, split_pages
from .layers import (dense, dense_init, gqa_attention, layer_norm, norm_init,
                     normal, param_shapes, softmax_xent, widest_dim_specs)

__all__ = ["WhisperConfig", "WhisperModel"]

Tree = Any

_PAGE = 16      # the largest page the lanes are viewed in


@dataclass(frozen=True)
class WhisperConfig:
    name: str
    n_enc_layers: int
    n_dec_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    n_frames: int = 1500
    max_positions: int = 448
    param_dtype: str = "bfloat16"
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.d_model // self.n_heads

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


def _sinusoid(length: int, d: int, device) -> torch.Tensor:
    """The encoder's position signal ``[length, d]`` in float32: sines
    then cosines of ``t * 10000^(-i / (d/2 - 1))``."""
    half = d // 2
    log = torch.log(torch.tensor(10000.0, device=device))
    freq = torch.exp(-log * torch.arange(half, device=device) / (half - 1))
    t = torch.arange(length, device=device)[:, None] * freq[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], 1)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def _layer(tree: Tree, i: int) -> Tree:
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


class WhisperModel:
    """Functional Whisper backbone: init / encode / apply / loss /
    prefill / decode, unit layout and analytic costs for the planner."""

    # decoder self-KV is position-addressed and length-masked: a
    # right-padded (chunked) prefill cannot leak into decode
    kv_position_indexed = True

    def __init__(self, cfg: WhisperConfig):
        self.cfg = cfg
        self._tables: dict[tuple, torch.Tensor] = {}

    # ------------------------------------------------------------------ init
    def _attn_init(self, g: torch.Generator, stack: tuple) -> Tree:
        d, dt = self.cfg.d_model, self.cfg.dtype
        return {"wq": dense_init(g, d, d, bias=True, dtype=dt, stack=stack),
                "wk": dense_init(g, d, d, dtype=dt, stack=stack),
                "wv": dense_init(g, d, d, bias=True, dtype=dt, stack=stack),
                "wo": dense_init(g, d, d, bias=True, dtype=dt,
                                 scale=d ** -0.5, stack=stack)}

    def _mlp_init(self, g: torch.Generator, stack: tuple) -> Tree:
        cfg = self.cfg
        return {"up": dense_init(g, cfg.d_model, cfg.d_ff, bias=True,
                                 dtype=cfg.dtype, stack=stack),
                "down": dense_init(g, cfg.d_ff, cfg.d_model, bias=True,
                                   dtype=cfg.dtype, scale=cfg.d_ff ** -0.5,
                                   stack=stack)}

    def _ln(self, g: torch.Generator, stack: tuple = ()) -> Tree:
        return norm_init(self.cfg.d_model, dtype=self.cfg.dtype, bias=True,
                         stack=stack, device=g.device)

    def init(self, generator: torch.Generator) -> Tree:
        """Random parameters on ``generator``'s device, in the reference
        layout and scales (the draws differ from JAX's)."""
        cfg = self.cfg
        g, dt, d = generator, cfg.dtype, cfg.d_model
        enc = (cfg.n_enc_layers,)
        dec = (cfg.n_dec_layers,)
        return {
            "embed": {"table": normal(g, (cfg.vocab, d), 1.0, dt),
                      "pos": normal(g, (cfg.max_positions, d), 0.02, dt)},
            "enc_blocks": {"ln1": self._ln(g, enc),
                           "attn": self._attn_init(g, enc),
                           "ln2": self._ln(g, enc),
                           "mlp": self._mlp_init(g, enc)},
            "bridge": {"ln": self._ln(g)},
            "dec_blocks": {"ln1": self._ln(g, dec),
                           "self_attn": self._attn_init(g, dec),
                           "ln_x": self._ln(g, dec),
                           "cross_attn": self._attn_init(g, dec),
                           "ln2": self._ln(g, dec),
                           "mlp": self._mlp_init(g, dec)},
            "head": {"norm": self._ln(g)},
        }

    def param_specs(self) -> Tree:
        """Logical-axis tree mirroring :meth:`init`'s output (the
        reference's rule: a stacked matrix shards the larger of its two
        dims over ``heads``; stacked biases and norms only ``layers``)."""
        specs = widest_dim_specs(param_shapes(self), 3)
        specs["embed"] = {"table": ("vocab", None), "pos": (None, None)}
        specs["bridge"] = {"ln": {"scale": (None,), "bias": (None,)}}
        specs["head"] = {"norm": {"scale": (None,), "bias": (None,)}}
        return specs

    # ----------------------------------------------------------------- apply
    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        b, s, _ = t.shape
        return t.reshape(b, s, self.cfg.n_heads, self.cfg.hd)

    def _attend(self, q, k, v, *, causal: bool, kernel: bool):
        """``[b, sq, H, hd]`` queries over keys from position 0: through
        the flash kernel (serving) or the plain attention (training)."""
        if kernel:
            out = flash_attention(q, k, v, causal=causal)
        else:
            out = gqa_attention(q, k, v, causal=causal)
        return out.reshape(q.shape[0], q.shape[1], -1)

    def _mlp(self, p, x):
        h = layer_norm(p["ln2"], x)
        return x + dense(p["mlp"]["down"],
                         _gelu(dense(p["mlp"]["up"], h)))

    def _enc_block(self, p, x, kernel: bool = False):
        h = layer_norm(p["ln1"], x)
        a = p["attn"]
        att = self._attend(self._heads(dense(a["wq"], h)),
                           self._heads(dense(a["wk"], h)),
                           self._heads(dense(a["wv"], h)),
                           causal=False, kernel=kernel)
        return self._mlp(p, x + dense(a["wo"], att))

    def _run(self, fn, remat: bool, *args):
        if remat:
            # no RNG state to keep (the model has no dropout)
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return fn(*args)

    def encode(self, params, frames: torch.Tensor, *, kernel: bool = False,
               remat: bool = False) -> torch.Tensor:
        """frames ``[b, n_frames, d]`` (precomputed conv-frontend output)
        -> encoder output ``[b, n_frames, d]``; frames and the sinusoid
        are each cast to the parameter dtype before the add, as in the
        reference."""
        cfg = self.cfg
        x = frames.to(cfg.dtype) + _sinusoid(
            frames.shape[1], cfg.d_model, frames.device).to(cfg.dtype)
        for i in range(cfg.n_enc_layers):
            x = self._run(self._enc_block, remat,
                          _layer(params["enc_blocks"], i), x, kernel)
        return layer_norm(params["bridge"]["ln"], x)

    def _embed(self, params, tokens, positions):
        pos = positions.clamp(0, self.cfg.max_positions - 1)
        return params["embed"]["table"][tokens] + params["embed"]["pos"][pos]

    def _dec_block(self, p, x, enc_out):
        """One decoder block over a whole sequence from position 0."""
        h = layer_norm(p["ln1"], x)
        a = p["self_attn"]
        att = self._attend(self._heads(dense(a["wq"], h)),
                           self._heads(dense(a["wk"], h)),
                           self._heads(dense(a["wv"], h)),
                           causal=True, kernel=False)
        x = x + dense(a["wo"], att)
        c = p["cross_attn"]
        att = self._attend(self._heads(dense(c["wq"],
                                             layer_norm(p["ln_x"], x))),
                           self._heads(dense(c["wk"], enc_out)),
                           self._heads(dense(c["wv"], enc_out)),
                           causal=False, kernel=False)
        return self._mlp(p, x + dense(c["wo"], att))

    def _head(self, params, x):
        x = layer_norm(params["head"]["norm"], x)
        return x @ params["embed"]["table"].T

    def apply(self, params, tokens, frames, *,
              remat: bool = False) -> torch.Tensor:
        """Full forward -> logits ``[b, s, vocab]``."""
        enc_out = self.encode(params, frames, remat=remat)
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        x = self._embed(params, tokens, positions)
        for i in range(self.cfg.n_dec_layers):
            x = self._run(self._dec_block, remat,
                          _layer(params["dec_blocks"], i), x, enc_out)
        return self._head(params, x)

    def loss(self, params, batch, *,
             segment_cuts: tuple[int, ...] = ()) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch = {tokens, labels,
        frames}``, float32 (``segment_cuts``: the reference's signature,
        no numeric effect here)."""
        del segment_cuts
        logits = self.apply(params, batch["tokens"], batch["frames"],
                            remat=self.cfg.remat and torch.is_grad_enabled())
        return softmax_xent(logits[:, :-1], batch["labels"][:, 1:])

    # --------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_seq: int, *, device) -> Tree:
        cfg = self.cfg
        z = dict(dtype=cfg.dtype, device=device)
        lane = (cfg.n_dec_layers, batch)
        heads = (cfg.n_heads, cfg.hd)
        return {"self": {n: torch.zeros((*lane, max_seq, *heads), **z)
                         for n in ("k", "v")},
                "cross_k": torch.zeros((*lane, cfg.n_frames, *heads), **z),
                "cross_v": torch.zeros((*lane, cfg.n_frames, *heads), **z)}

    def prefill(self, params, tokens, cache, frames
                ) -> tuple[torch.Tensor, Tree]:
        """Encode the frames, write every layer's cross K/V and the
        prompt's self K/V (positions ``[0, s)``) into ``cache`` in place;
        returns (last-token logits ``[b, 1, vocab]``, cache).  All three
        attentions run the flash kernel from position 0: the reference
        attends the whole self lane with positions ``>= s`` masked, which
        is the same function."""
        cfg = self.cfg
        enc_out = self.encode(params, frames, kernel=True)
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        x = self._embed(params, tokens, positions)
        for i in range(cfg.n_dec_layers):
            p = _layer(params["dec_blocks"], i)
            h = layer_norm(p["ln1"], x)
            a = p["self_attn"]
            k = self._heads(dense(a["wk"], h))
            v = self._heads(dense(a["wv"], h))
            cache["self"]["k"][i, :, :s] = k
            cache["self"]["v"][i, :, :s] = v
            att = self._attend(self._heads(dense(a["wq"], h)), k, v,
                               causal=True, kernel=True)
            x = x + dense(a["wo"], att)
            c = p["cross_attn"]
            k = self._heads(dense(c["wk"], enc_out))
            v = self._heads(dense(c["wv"], enc_out))
            cache["cross_k"][i] = k
            cache["cross_v"][i] = v
            q = self._heads(dense(c["wq"], layer_norm(p["ln_x"], x)))
            att = self._attend(q, k, v, causal=False, kernel=True)
            x = self._mlp(p, x + dense(c["wo"], att))
        return self._head(params, x[:, -1:]), cache

    @staticmethod
    def lane_page(depth: int) -> int:
        """Keys a page of the lane-as-pages view of a ``depth``-deep
        lane: the largest divisor of ``depth`` up to 16."""
        return math.gcd(depth, _PAGE)

    def lane_table(self, lanes: int, depth: int, device) -> torch.Tensor:
        """The constant block table ``[lanes, depth / ps]`` int32 that
        views ``lanes`` contiguous lanes of ``depth`` keys, ``[lanes *
        depth / ps, ps, heads, hd]``, as pages: lane ``b``'s page ``j``
        is page ``b * depth / ps + j``.  Built once per (lanes, depth,
        device)."""
        key = (lanes, depth, str(torch.device(device)))
        table = self._tables.get(key)
        if table is None:
            per = depth // self.lane_page(depth)
            table = torch.arange(lanes * per, dtype=torch.int32,
                                 device=device).reshape(lanes, per)
            self._tables[key] = table
        return table

    def _frames_len(self, lanes: int, device) -> torch.Tensor:
        key = ("kv_len", lanes, str(torch.device(device)))
        kv_len = self._tables.get(key)
        if kv_len is None:
            kv_len = torch.full((lanes,), self.cfg.n_frames,
                                dtype=torch.int32, device=device)
            self._tables[key] = kv_len
        return kv_len

    def decode_scratch(self, lanes: int, device, max_seq: int):
        """The paged kernel's split-K scratch for ``lanes``-wide decode
        steps over ``max_seq``-deep self lanes on ``device`` (``None``
        when no launch needs one): sized for the larger of the self and
        the cross launch, which share it in order on one stream.  A
        caller whose launches must keep their addresses (a captured CUDA
        graph) owns it and passes it to every step."""
        cfg = self.cfg
        device = torch.device(device)
        blocks = max((split_pages(lanes, cfg.n_heads, n, sm_count(device))[0],
                      n) for n in (max_seq // self.lane_page(max_seq),
                                   cfg.n_frames // self.lane_page(
                                       cfg.n_frames)))[1]
        return launch_scratch(lanes, cfg.n_heads, cfg.n_heads, cfg.hd,
                              blocks, device)

    def _lane_attention(self, q, k_lane, v_lane, kv_len, scratch):
        """One query per lane over its contiguous lane ``[lanes, depth,
        H, hd]`` read as pages through :meth:`lane_table`."""
        lanes, depth = k_lane.shape[:2]
        ps = self.lane_page(depth)
        shape = (lanes * depth // ps, ps, self.cfg.n_heads, self.cfg.hd)
        out = paged_attention(q, k_lane.view(shape), v_lane.view(shape),
                              self.lane_table(lanes, depth, q.device),
                              kv_len, scratch=scratch)
        return out.reshape(lanes, 1, -1)

    def decode_step(self, params, cache, token, pos, *, attn_scratch=None
                    ) -> tuple[torch.Tensor, Tree]:
        """One-token step of every lane against its cached self and cross
        K/V (no re-encode; ``token [b, 1]``, ``pos [b]``: each lane at its
        own position), the cache updated in place.  Each lane writes its
        self K/V at ``pos``; both attentions run the paged kernel over the
        lanes seen as pages (``attn_scratch``: its scratch of the caller's
        own, :meth:`decode_scratch`).  Returns (logits ``[b, 1, vocab]``,
        cache)."""
        cfg = self.cfg
        b = token.shape[0]
        x = self._embed(params, token, pos[:, None])
        depth = cache["self"]["k"].shape[2]
        rows = torch.arange(b, device=x.device)
        # dynamic_update_slice clamps its index into range; so does this
        write = pos.long().clamp(0, depth - 1)
        self_len = pos.to(torch.int32) + 1
        cross_len = self._frames_len(b, x.device)
        for i in range(cfg.n_dec_layers):
            p = _layer(params["dec_blocks"], i)
            h = layer_norm(p["ln1"], x)
            a = p["self_attn"]
            ck, cv = cache["self"]["k"][i], cache["self"]["v"][i]
            ck[rows, write] = self._heads(dense(a["wk"], h))[:, 0]
            cv[rows, write] = self._heads(dense(a["wv"], h))[:, 0]
            q = self._heads(dense(a["wq"], h))[:, 0]
            x = x + dense(a["wo"], self._lane_attention(
                q, ck, cv, self_len, attn_scratch))
            c = p["cross_attn"]
            q = self._heads(dense(c["wq"], layer_norm(p["ln_x"], x)))[:, 0]
            x = x + dense(c["wo"], self._lane_attention(
                q, cache["cross_k"][i], cache["cross_v"][i], cross_len,
                attn_scratch))
            x = self._mlp(p, x)
        return self._head(params, x), cache

    # ------------------------------------------------------------- structure
    def unit_layout(self) -> UnitLayout:
        cfg = self.cfg
        entries = [UnitEntry("embed", "embed", None)]
        entries += [UnitEntry(f"enc_{i}", "enc_blocks", i)
                    for i in range(cfg.n_enc_layers)]
        entries.append(UnitEntry("bridge", "bridge", None))
        entries += [UnitEntry(f"dec_{i}", "dec_blocks", i)
                    for i in range(cfg.n_dec_layers)]
        entries.append(UnitEntry("head", "head", None))
        return UnitLayout(tuple(entries))

    def _attn_params(self) -> int:
        d = self.cfg.d_model
        return 4 * d * d + 3 * d          # q,k,v,o + q/v/o biases

    def _mlp_params(self) -> int:
        cfg = self.cfg
        return 2 * cfg.d_model * cfg.d_ff + cfg.d_ff + cfg.d_model

    def _enc_block_params(self) -> int:
        return self._attn_params() + self._mlp_params() \
            + 4 * self.cfg.d_model

    def _dec_block_params(self) -> int:
        return 2 * self._attn_params() + self._mlp_params() \
            + 6 * self.cfg.d_model

    def param_count(self) -> int:
        cfg = self.cfg
        return (cfg.vocab * cfg.d_model + cfg.max_positions * cfg.d_model
                + cfg.n_enc_layers * self._enc_block_params()
                + 2 * cfg.d_model                       # bridge ln
                + cfg.n_dec_layers * self._dec_block_params()
                + 2 * cfg.d_model)                      # head ln

    def active_param_count(self) -> int:
        return self.param_count()

    def layer_costs(self, batch: int, seq: int, *,
                    mode: str = "train") -> list[tuple[str, float, float]]:
        """(unit_name, n_params, fwd_flops) per unit, the reference's
        formulas; ``mode="decode"`` charges one-token steps and no
        encoder (the audio is encoded once, at prefill)."""
        cfg = self.cfg
        d = cfg.d_model
        enc_t = batch * cfg.n_frames
        dec_t = batch * (seq if mode == "train" else 1)
        kv_len = seq
        out = [("embed", float((cfg.vocab + cfg.max_positions) * d),
                2.0 * dec_t * d)]
        enc_f = 2.0 * enc_t * (4 * d * d + 2 * d * cfg.d_ff) \
            + 2.0 * enc_t * cfg.n_frames * d * 2
        if mode != "train":
            enc_f = 0.0
        for i in range(cfg.n_enc_layers):
            out.append((f"enc_{i}", float(self._enc_block_params()), enc_f))
        out.append(("bridge", float(2 * d), 0.0))
        dec_f = 2.0 * dec_t * (8 * d * d + 2 * d * cfg.d_ff) \
            + 2.0 * dec_t * kv_len * d * 2 \
            + 2.0 * dec_t * cfg.n_frames * d * 2
        for i in range(cfg.n_dec_layers):
            out.append((f"dec_{i}", float(self._dec_block_params()), dec_f))
        out.append(("head", float(2 * d), 2.0 * dec_t * d * cfg.vocab))
        return out
