"""Dense decoder-only LM (GQA, SwiGLU/GELU, RMSNorm/LayerNorm, RoPE).

Counterpart of the dense run of ``repro.models.transformer``.  The model
is functional: it holds only its config, and every method takes the
parameter dict, which keeps the reference layout — ``embed`` /
``blocks`` (leaves stacked ``[n_layers, ...]``) / ``head`` — so trees
carry across with :mod:`repro_torch.convert`.  ``lax.scan`` over layers
becomes a Python loop over the stacked axis.

Caches are dicts ``{"blocks": {"k", "v"}}`` of real zero tensors
``[n_layers, batch, max_seq, n_kv, hd]`` (contiguous) or ``[n_layers,
n_pages, page_size, n_kv, hd]`` (paged pool).  Prefill and decode write
them **in place** and return the same dict (the reference returns a new
one): a full-width pool is too large to copy per token.

Prefill attention goes through the flash kernel (CUDA on the card, its
plain version on the CPU); paged decode goes through the paged kernel.
Contiguous decode, ``apply`` and the training ``loss`` use the plain
:func:`~repro_torch.models.layers.gqa_attention`, as the reference does
(it trains on jnp attention outside any Pallas kernel, ROADMAP.md C3).
With ``remat`` each block of the training forward is recomputed in the
backward pass (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``).

MoE, MLA and multi-token prediction are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..core.partial_sync import UnitEntry, UnitLayout
from ..kernels.flash_attention import flash_attention
from ..kernels.paged_attention import paged_attention, write_token_to_pages
from .layers import (apply_rope, dense, dense_init, embed, embed_init,
                     gqa_attention, layer_norm, mlp_apply, mlp_init,
                     norm_init, rms_norm, rope_freqs, softmax_xent)

__all__ = ["LMConfig", "DecoderLM"]

Tree = Any


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    qkv_bias: bool = False
    qk_norm: bool = False
    mlp_kind: str = "swiglu"
    norm_kind: str = "rmsnorm"
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    window: int | None = None             # local attention window
    param_dtype: str = "bfloat16"
    remat: bool = True
    # MoE / MLA / MTP: not ported yet (DecoderLM raises)
    moe: Any = None
    n_dense_layers: int = 0
    dense_d_ff: int | None = None
    mla: Any = None
    mtp: bool = False
    mtp_weight: float = 0.3

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


def _layer(tree: Tree, i: int) -> Tree:
    """Layer ``i`` of a stacked group (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


class DecoderLM:
    """Functional dense decoder LM (init / apply / loss / prefill /
    decode, contiguous and paged; unit layout and analytic costs for the
    planner)."""

    # cache entries are addressed by position and masked by valid length,
    # so right-padded (chunked) prefill cannot leak into decode
    kv_position_indexed = True
    # GQA stores position-addressed KV, so the cache can live in pages
    supports_paged_kv = True

    def __init__(self, cfg: LMConfig):
        if cfg.moe is not None or cfg.mla is not None or cfg.mtp:
            raise NotImplementedError(
                f"{cfg.name}: MoE, MLA and multi-token prediction are not "
                "ported to repro_torch yet (ROADMAP.md queue A item 9)")
        self.cfg = cfg

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> Tree:
        """Random parameters on ``generator``'s device, in the reference
        layout and scales (the draws differ from JAX's)."""
        cfg = self.cfg
        g, dt, n = generator, cfg.dtype, cfg.n_layers
        d, hd, dev = cfg.d_model, cfg.hd, generator.device
        ln_bias = cfg.norm_kind == "layernorm"
        stack = (n,)
        attn = {
            "wq": dense_init(g, d, cfg.n_heads * hd, bias=cfg.qkv_bias,
                             dtype=dt, stack=stack),
            "wk": dense_init(g, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                             dtype=dt, stack=stack),
            "wv": dense_init(g, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                             dtype=dt, stack=stack),
            "wo": dense_init(g, cfg.n_heads * hd, d, dtype=dt,
                             scale=(cfg.n_heads * hd) ** -0.5, stack=stack),
        }
        if cfg.qk_norm:
            attn["q_norm"] = norm_init(hd, dtype=dt, stack=stack, device=dev)
            attn["k_norm"] = norm_init(hd, dtype=dt, stack=stack, device=dev)
        blocks = {
            "ln1": norm_init(d, dtype=dt, bias=ln_bias, stack=stack,
                             device=dev),
            "attn": attn,
            "ln2": norm_init(d, dtype=dt, bias=ln_bias, stack=stack,
                             device=dev),
            "mlp": mlp_init(g, d, cfg.dense_d_ff or cfg.d_ff,
                            kind=cfg.mlp_kind, dtype=dt, stack=stack),
        }
        head = {"norm": norm_init(d, dtype=dt, bias=ln_bias, device=dev)}
        if not cfg.tie_embeddings:
            head["out"] = dense_init(g, d, cfg.vocab, dtype=dt)
        return {"embed": embed_init(g, cfg.vocab, d, dtype=dt),
                "blocks": blocks, "head": head}

    # ----------------------------------------------------------------- apply
    def _project_qkv(self, p, x, positions):
        """Shared GQA preamble: projections, optional qk-norm, RoPE."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.hd
        q = dense(p["wq"], x).reshape(b, s, cfg.n_heads, hd)
        k = dense(p["wk"], x).reshape(b, s, cfg.n_kv_heads, hd)
        v = dense(p["wv"], x).reshape(b, s, cfg.n_kv_heads, hd)
        if cfg.qk_norm:
            q = rms_norm(p["q_norm"], q)
            k = rms_norm(p["k_norm"], k)
        inv_freq = rope_freqs(hd, cfg.rope_theta, device=x.device)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
        return q, k, v

    def _norm(self, p, x):
        return (rms_norm(p, x) if self.cfg.norm_kind == "rmsnorm"
                else layer_norm(p, x))

    def _block(self, attend, i, p, x):
        x = x + attend(i, p["attn"], self._norm(p["ln1"], x))
        return x + mlp_apply(p["mlp"], self._norm(p["ln2"], x),
                             kind=self.cfg.mlp_kind)

    def _blocks(self, params, x, attend, *, remat: bool = False):
        """Run the block stack; ``attend(layer, p_attn, h)`` is the
        attention sub-layer of one mode (full, prefill, decode, paged).
        ``remat`` recomputes each block in the backward pass instead of
        keeping its activations."""
        for i in range(self.cfg.n_layers):
            p = _layer(params["blocks"], i)
            if remat:
                x = checkpoint(self._block, attend, i, p, x,
                               use_reentrant=False)
            else:
                x = self._block(attend, i, p, x)
        return x

    def _head(self, params, x):
        x = self._norm(params["head"]["norm"], x)
        if self.cfg.tie_embeddings:
            return x @ params["embed"]["table"].T
        return dense(params["head"]["out"], x)

    def _backbone(self, params, tokens, positions=None, *,
                  remat: bool = False) -> torch.Tensor:
        """Embed + block stack -> final hidden states ``[b, s, d]``."""
        cfg = self.cfg
        x = embed(params["embed"], tokens)
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=x.device).expand(b, s)

        def attend(_i, p, h):
            q, k, v = self._project_qkv(p, h, positions)
            out = gqa_attention(q, k, v, q_positions=positions,
                                kv_positions=positions, causal=True,
                                window=cfg.window)
            return out.reshape(b, s, -1) @ p["wo"]["w"]

        return self._blocks(params, x, attend, remat=remat)

    def apply(self, params, tokens, *, positions=None) -> torch.Tensor:
        """Full-sequence forward -> logits ``[b, s, vocab]``."""
        return self._head(params, self._backbone(params, tokens, positions))

    # ----------------------------------------------------------------- loss
    def loss(self, params, batch, *,
             segment_cuts: tuple[int, ...] = ()) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch = {tokens, labels}``
        (``[b, s]`` each), float32.

        ``segment_cuts`` is accepted for the reference's signature: there
        it splits the layer scan so XLA can overlap a phase's sync with
        the remaining backward; in eager PyTorch it has no numeric effect
        (the overlap it serves is ROADMAP.md queue A item 6)."""
        del segment_cuts
        x = self._backbone(params, batch["tokens"],
                           remat=self.cfg.remat and torch.is_grad_enabled())
        logits = self._head(params, x)
        labels = batch["labels"]
        return softmax_xent(logits[:, :-1], labels[:, 1:])

    # --------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_seq: int, *, device) -> Tree:
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
        return {"blocks": {
            name: torch.zeros(shape, dtype=cfg.dtype, device=device)
            for name in ("k", "v")}}

    def prefill(self, params, tokens, cache) -> tuple[torch.Tensor, Tree]:
        """Write ``tokens``' KV into positions ``[0, s)`` of every lane of
        ``cache`` (in place) and return (last-token logits ``[b, 1,
        vocab]``, cache).

        Prefill always starts at position 0, so its attention is causal
        over ``[0, s)`` — exactly the flash kernel's contract.  The
        reference attends the whole cache lane with positions ``>= s``
        masked, which is the same function.
        """
        cfg = self.cfg
        x = embed(params["embed"], tokens)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        ck, cv = cache["blocks"]["k"], cache["blocks"]["v"]

        def attend(i, p, h):
            q, k, v = self._project_qkv(p, h, positions)
            ck[i, :, :s] = k
            cv[i, :, :s] = v
            out = flash_attention(q, k, v, causal=True, window=cfg.window)
            return out.reshape(b, s, -1) @ p["wo"]["w"]

        x = self._blocks(params, x, attend)
        return self._head(params, x[:, -1:]), cache

    def decode_step(self, params, cache, token, pos
                    ) -> tuple[torch.Tensor, Tree]:
        """One-token decode with a write position per lane (in place).

        ``token [b, 1]``, ``pos [b]``.  Each lane writes its own
        position, which is what the reference gets by vmapping its
        single-lane step over the slots.  Returns (logits ``[b, 1,
        vocab]``, cache).
        """
        cfg = self.cfg
        x = embed(params["embed"], token)
        b = x.shape[0]
        ck, cv = cache["blocks"]["k"], cache["blocks"]["v"]
        max_seq = ck.shape[2]
        positions = pos[:, None]
        rows = torch.arange(b, device=x.device)
        # dynamic_update_slice clamps its index into range; so does this
        write = pos.long().clamp(0, max_seq - 1)
        kv_pos = torch.arange(max_seq, device=x.device).expand(b, max_seq)

        def attend(i, p, h):
            q, k, v = self._project_qkv(p, h, positions)
            ck[i, rows, write] = k[:, 0]
            cv[i, rows, write] = v[:, 0]
            out = gqa_attention(q, ck[i], cv[i], q_positions=positions,
                                kv_positions=kv_pos, causal=True,
                                window=cfg.window, kv_valid_len=pos + 1)
            return out.reshape(b, 1, -1) @ p["wo"]["w"]

        x = self._blocks(params, x, attend)
        return self._head(params, x), cache

    # -------------------------------------------------------- paged serving
    def init_paged_cache(self, n_pages: int, page_size: int, *,
                         device) -> Tree:
        """Global KV page pool ``[n_layers, n_pages, page_size, n_kv,
        hd]`` for k and v; page 0 is the pool's trash page."""
        cfg = self.cfg
        shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.hd)
        return {"blocks": {
            name: torch.zeros(shape, dtype=cfg.dtype, device=device)
            for name in ("k", "v")}}

    def decode_step_paged(self, params, pages, token, pos, block_tables,
                          active) -> tuple[torch.Tensor, Tree]:
        """Slot-batched one-token decode against the page pool.

        ``token [slots, 1]``, ``pos [slots]`` int32 write index,
        ``block_tables [slots, max_blocks]`` int32, ``active [slots]``
        bool (inactive lanes write the trash page).  Each layer writes
        this token's KV into its page (in place), then attends through
        the block table with the paged kernel.  Returns (logits
        ``[slots, 1, vocab]``, pages).
        """
        cfg = self.cfg
        x = embed(params["embed"], token)
        b = x.shape[0]
        positions = pos[:, None]
        kv_len = pos + 1
        pk, pv = pages["blocks"]["k"], pages["blocks"]["v"]

        def attend(i, p, h):
            q, k, v = self._project_qkv(p, h, positions)
            write_token_to_pages(pk[i], block_tables, pos, active, k[:, 0])
            write_token_to_pages(pv[i], block_tables, pos, active, v[:, 0])
            out = paged_attention(q[:, 0], pk[i], pv[i], block_tables,
                                  kv_len, window=cfg.window)
            return out.reshape(b, 1, -1) @ p["wo"]["w"]

        x = self._blocks(params, x, attend)
        return self._head(params, x), pages

    # ------------------------------------------------------------- structure
    def unit_layout(self) -> UnitLayout:
        """Schedulable units in network order: ``embed``, one per layer
        of ``blocks``, ``head``."""
        entries = [UnitEntry("embed", "embed", None)]
        entries += [UnitEntry(f"layer_{i}", "blocks", i)
                    for i in range(self.cfg.n_layers)]
        entries.append(UnitEntry("head", "head", None))
        return UnitLayout(tuple(entries))

    # ---------------------------------------------------- analytic accounting
    def _block_param_count(self) -> int:
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.hd
        attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) \
            + cfg.n_heads * hd * d
        if cfg.qkv_bias:
            attn += hd * (cfg.n_heads + 2 * cfg.n_kv_heads)
        if cfg.qk_norm:
            attn += 2 * hd
        norms = 2 * d * (2 if cfg.norm_kind == "layernorm" else 1)
        mlp = d * (cfg.dense_d_ff or cfg.d_ff) \
            * (3 if cfg.mlp_kind == "swiglu" else 2)
        return attn + mlp + norms

    def param_count(self) -> int:
        cfg = self.cfg
        n = cfg.vocab * cfg.d_model + cfg.n_layers * self._block_param_count() \
            + cfg.d_model
        if not cfg.tie_embeddings:
            n += cfg.d_model * cfg.vocab
        return n

    def _block_fwd_flops(self, tokens: int, kv_len: int) -> float:
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.hd
        proj = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) \
            + cfg.n_heads * hd * d
        att_len = kv_len if cfg.window is None else min(kv_len, cfg.window)
        attn = 2.0 * tokens * proj \
            + 2.0 * tokens * att_len * cfg.n_heads * hd * 2
        d_ff = cfg.dense_d_ff or cfg.d_ff
        mlp = 2.0 * tokens * d * d_ff * (3 if cfg.mlp_kind == "swiglu"
                                         else 2)
        return attn + mlp

    def layer_costs(self, batch: int, seq: int, *,
                    mode: str = "train") -> list[tuple[str, float, float]]:
        """(unit_name, n_params, fwd_flops) per unit — profiler input.

        ``mode="decode"`` charges one-token steps against a ``seq``-deep KV
        cache (serving shapes)."""
        cfg = self.cfg
        tokens = batch * seq if mode == "train" else batch
        out = [("embed", float(cfg.vocab * cfg.d_model),
                2.0 * tokens * cfg.d_model)]
        per_p = float(self._block_param_count())
        per_f = self._block_fwd_flops(tokens, seq)
        out += [(f"layer_{i}", per_p, per_f) for i in range(cfg.n_layers)]
        head_p = float(cfg.d_model + (0 if cfg.tie_embeddings
                                      else cfg.d_model * cfg.vocab))
        out.append(("head", head_p, 2.0 * tokens * cfg.d_model * cfg.vocab))
        return out
