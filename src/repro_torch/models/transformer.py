"""Decoder-only LM: dense GQA, MoE and MLA (SwiGLU/GELU,
RMSNorm/LayerNorm, RoPE), with DeepSeek-V3's multi-token prediction.

Counterpart of ``repro.models.transformer``.  The model is functional:
it holds only its config, and every method takes the parameter dict,
which keeps the reference layout — ``embed`` / [``dense_blocks``] /
``blocks`` / [``mtp``] / ``head``, block groups stacked ``[layers,
...]`` (:meth:`LMConfig.runs`: a dense model has one ``blocks`` group
of dense blocks; an MoE model an optional leading ``dense_blocks`` group
and a ``blocks`` group of MoE blocks; ``mtp`` is one unstacked block of
the last group's kind with its projection and norm) — so trees carry
across with :mod:`repro_torch.convert`.  ``lax.scan`` over each group
becomes a Python loop over its stacked axis.

Caches are dicts with one entry per block group of real zero tensors:
GQA ``{"k", "v"}`` ``[layers, batch, max_seq, n_kv, hd]`` (contiguous)
or ``[layers, n_pages, page_size, n_kv, hd]`` (paged pool); MLA the
latents ``{"c_kv": [layers, ..., r_kv], "k_rope": [layers, ...,
rope]}`` in the same two layouts.  Prefill and decode write them **in
place** and return the same dict (the reference returns a new one): a
full-width pool is too large to copy per token.

A vision frontend (llava) brings ``embeds [b, n, d]``, patch
embeddings that ``apply``, ``loss`` and ``prefill`` prepend to the
token embeddings (cast to the parameter dtype); they take positions
``[0, n)``, the text follows, and the loss covers the text tail only.

GQA prefill attention goes through the flash kernel (CUDA on the card,
its plain version on the CPU); GQA paged decode goes through the paged
kernel.  Contiguous decode, ``apply`` and the training ``loss`` use the
plain :func:`~repro_torch.models.layers.gqa_attention`, as the
reference does (it trains on jnp attention outside any Pallas kernel,
ROADMAP.md C3).  MLA runs :mod:`repro_torch.models.mla` in every mode
(torch operations; neither attention kernel applies to it).  With
``remat`` each block of the training forward is recomputed in the
backward pass (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``; no RNG state is saved, as the model draws none).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..core.partial_sync import UnitEntry, UnitLayout
from ..kernels.flash_attention import flash_attention
from ..kernels.paged_attention import paged_attention, write_token_to_pages
from ..spans import span
from .layers import (apply_rope, dense, dense_init, dense_spec, embed,
                     embed_init, gqa_attention, layer_norm, mlp_apply,
                     mlp_init, mlp_spec, norm_init, norm_spec, rms_norm,
                     rope_freqs, softmax_xent, stacked_spec)
from .mla import (MLAConfig, mla_apply_full, mla_decode, mla_decode_paged,
                  mla_fwd_flops, mla_init, mla_init_cache,
                  mla_init_paged_cache, mla_param_count, mla_specs)
from .moe import (MoEConfig, RoutedRows, moe_active_param_count, moe_apply,
                  moe_fwd_flops, moe_init, moe_param_count, moe_specs)

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
    # MoE
    moe: MoEConfig | None = None
    n_dense_layers: int = 0               # leading dense layers (dsv3: 3)
    dense_d_ff: int | None = None
    # MLA
    mla: MLAConfig | None = None
    # Multi-token prediction (dsv3)
    mtp: bool = False
    mtp_weight: float = 0.3

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def runs(self) -> list[tuple[str, str, int]]:
        """(group_name, block_kind, n_layers) in network order."""
        if self.moe is None:
            return [("blocks", "dense", self.n_layers)]
        out = []
        if self.n_dense_layers:
            out.append(("dense_blocks", "dense", self.n_dense_layers))
        out.append(("blocks", "moe", self.n_layers - self.n_dense_layers))
        return out


def _layer(tree: Tree, i: int) -> Tree:
    """Layer ``i`` of a stacked group (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


class DecoderLM:
    """Functional decoder LM, dense, MoE or MLA (init / apply / loss /
    prefill / decode, contiguous and paged; unit layout and analytic
    costs for the planner)."""

    # cache entries are addressed by position and masked by valid length,
    # so right-padded (chunked) prefill cannot leak into decode
    kv_position_indexed = True
    # GQA and MLA store position-addressed KV (heads or latents), so the
    # cache can live in pages
    supports_paged_kv = True

    def __init__(self, cfg: LMConfig):
        self.cfg = cfg
        # the dropless expert layer's rows per held expert, counted once a
        # forward of a training or full-sequence pass (not in serving)
        self.routed_rows = None
        if cfg.moe is not None and cfg.moe.dropless:
            n_moe = cfg.n_layers - cfg.n_dense_layers
            self.routed_rows = RoutedRows(n_moe, cfg.moe.held[1])

    # ------------------------------------------------------------------ init
    def _attn_init(self, g: torch.Generator, stack: tuple) -> Tree:
        cfg = self.cfg
        dt, d, hd, dev = cfg.dtype, cfg.d_model, cfg.hd, g.device
        if cfg.mla is not None:
            return mla_init(g, cfg.mla, d, dtype=dt, stack=stack)
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
        return attn

    def _block_init(self, g: torch.Generator, kind: str,
                    stack: tuple = ()) -> Tree:
        """One block's parameters, or a group's stacked ``[*stack, ...]``."""
        cfg = self.cfg
        dt, d, dev = cfg.dtype, cfg.d_model, g.device
        ln_bias = cfg.norm_kind == "layernorm"
        attn = self._attn_init(g, stack)
        if kind == "moe":
            mlp = moe_init(g, cfg.moe, d, dtype=dt, stack=stack)
        else:
            mlp = mlp_init(g, d, cfg.dense_d_ff or cfg.d_ff,
                           kind=cfg.mlp_kind, dtype=dt, stack=stack)
        return {
            "ln1": norm_init(d, dtype=dt, bias=ln_bias, stack=stack,
                             device=dev),
            "attn": attn,
            "ln2": norm_init(d, dtype=dt, bias=ln_bias, stack=stack,
                             device=dev),
            "mlp": mlp,
        }

    def init(self, generator: torch.Generator) -> Tree:
        """Random parameters on ``generator``'s device, in the reference
        layout and scales (the draws differ from JAX's): each block group
        of :meth:`LMConfig.runs`, the MTP module, the head, then the
        embedding."""
        cfg = self.cfg
        g, dt, d = generator, cfg.dtype, cfg.d_model
        groups = {group: self._block_init(g, kind, (n,))
                  for group, kind, n in cfg.runs()}
        if cfg.mtp:
            groups["mtp"] = {
                "block": self._block_init(g, cfg.runs()[-1][1]),
                "proj": dense_init(g, 2 * d, d, dtype=dt),
                "norm": norm_init(d, dtype=dt, device=g.device)}
        head = {"norm": norm_init(d, dtype=dt,
                                  bias=cfg.norm_kind == "layernorm",
                                  device=g.device)}
        if not cfg.tie_embeddings:
            head["out"] = dense_init(g, d, cfg.vocab, dtype=dt)
        return {"embed": embed_init(g, cfg.vocab, d, dtype=dt), **groups,
                "head": head}

    def _block_spec(self, kind: str) -> Tree:
        """Logical axes of one unstacked block (:meth:`_block_init`)."""
        cfg = self.cfg
        ln = norm_spec(bias=cfg.norm_kind == "layernorm")
        if cfg.mla is not None:
            attn = mla_specs(cfg.mla)
        else:
            attn = {"wq": dense_spec(None, "heads", bias=cfg.qkv_bias),
                    "wk": dense_spec(None, "heads", bias=cfg.qkv_bias),
                    "wv": dense_spec(None, "heads", bias=cfg.qkv_bias),
                    "wo": dense_spec("heads", None)}
            if cfg.qk_norm:
                attn["q_norm"] = norm_spec()
                attn["k_norm"] = norm_spec()
        mlp = moe_specs(cfg.moe) if kind == "moe" else mlp_spec(cfg.mlp_kind)
        return {"ln1": ln, "attn": attn, "ln2": dict(ln), "mlp": mlp}

    def param_specs(self) -> Tree:
        """Logical-axis tree mirroring :meth:`init`'s output, leaf for
        leaf (the reference's ``param_specs``): stacked groups get a
        leading ``layers`` axis."""
        cfg = self.cfg
        specs: dict = {"embed": {"table": ("vocab", None)}}
        for group, kind, _ in cfg.runs():
            specs[group] = stacked_spec(self._block_spec(kind))
        if cfg.mtp:
            specs["mtp"] = {"block": self._block_spec(cfg.runs()[-1][1]),
                            "proj": {"w": (None, None)},
                            "norm": {"scale": (None,)}}
        head: dict = {"norm": norm_spec(bias=cfg.norm_kind == "layernorm")}
        if not cfg.tie_embeddings:
            head["out"] = {"w": (None, "vocab")}
        specs["head"] = head
        return specs

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

    def _attend_full(self, p, h, positions):
        """Causal self-attention of a whole sequence (no cache)."""
        cfg = self.cfg
        if cfg.mla is not None:
            return mla_apply_full(p, cfg.mla, h, positions)[0]
        b, s, _ = h.shape
        q, k, v = self._project_qkv(p, h, positions)
        out = gqa_attention(q, k, v, q_positions=positions,
                            kv_positions=positions, causal=True,
                            window=cfg.window)
        return out.reshape(b, s, -1) @ p["wo"]["w"]

    def _norm(self, p, x):
        return (rms_norm(p, x) if self.cfg.norm_kind == "rmsnorm"
                else layer_norm(p, x))

    def _block(self, attend, group, kind, i, p, x):
        x = x + attend(group, i, p["attn"], self._norm(p["ln1"], x))
        h = self._norm(p["ln2"], x)
        if kind == "moe":
            return x + moe_apply(p["mlp"], self.cfg.moe, h,
                                 rows=self.routed_rows, layer=i)
        return x + mlp_apply(p["mlp"], h, kind=self.cfg.mlp_kind)

    def _blocks(self, params, x, attend, *, remat: bool = False):
        """Run the block groups in network order; ``attend(group, layer,
        p_attn, h)`` is the attention sub-layer of one mode (full,
        prefill, decode, paged).  ``remat`` recomputes each block in the
        backward pass instead of keeping its activations."""
        for group, kind, n in self.cfg.runs():
            for i in range(n):
                p = _layer(params[group], i)
                if kind == "moe" and self.routed_rows is not None:
                    self.routed_rows.arm(i)     # counted once, not on remat
                if remat:
                    # no RNG state to keep (the model has no dropout), and
                    # saving it is not allowed while a CUDA graph captures
                    x = checkpoint(self._block, attend, group, kind, i, p, x,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    x = self._block(attend, group, kind, i, p, x)
        return x

    def _head(self, params, x):
        x = self._norm(params["head"]["norm"], x)
        if self.cfg.tie_embeddings:
            return x @ params["embed"]["table"].T
        return dense(params["head"]["out"], x)

    def _embed(self, params, tokens, embeds) -> torch.Tensor:
        """Token embeddings, with ``embeds [b, n, d]`` (a vision prefix
        of patch embeddings) cast to the parameter dtype and prepended."""
        parts = []
        if embeds is not None:
            parts.append(embeds.to(self.cfg.dtype))
        if tokens is not None:
            parts.append(embed(params["embed"], tokens))
        return torch.cat(parts, 1) if len(parts) > 1 else parts[0]

    def _backbone(self, params, tokens, positions=None, *, embeds=None,
                  remat: bool = False) -> torch.Tensor:
        """Embed (``embeds`` prepended) + block stack -> final hidden
        states ``[b, n + s, d]``."""
        x = self._embed(params, tokens, embeds)
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=x.device).expand(b, s)

        def attend(_group, _i, p, h):
            return self._attend_full(p, h, positions)

        return self._blocks(params, x, attend, remat=remat)

    def apply(self, params, tokens=None, *, embeds=None,
              positions=None) -> torch.Tensor:
        """Full-sequence forward -> logits ``[b, n + s, vocab]`` (``embeds
        [b, n, d]``: a prefix of patch embeddings)."""
        return self._head(params, self._backbone(params, tokens, positions,
                                                 embeds=embeds))

    # ----------------------------------------------------------------- loss
    def loss(self, params, batch, *,
             segment_cuts: tuple[int, ...] = ()) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch = {tokens, labels}``
        (``[b, s]`` each), float32; with ``mtp``, plus ``mtp_weight``
        times the multi-token-prediction loss.  With ``batch["embeds"]``
        (``[b, n, d]``, a vision prefix) the loss covers the text tail
        only.

        ``segment_cuts`` is accepted for the reference's signature: there
        it splits the layer scan so XLA can overlap a phase's sync with
        the remaining backward; in eager PyTorch it has no numeric effect
        (the overlap it serves is ROADMAP.md queue A item 6)."""
        del segment_cuts
        cfg = self.cfg
        embeds = batch.get("embeds")
        x = self._backbone(params, batch.get("tokens"), embeds=embeds,
                           remat=cfg.remat and torch.is_grad_enabled())
        if embeds is not None:           # VLM: loss on the text tail only
            x = x[:, embeds.shape[1]:]
        logits = self._head(params, x)
        labels = batch["labels"]
        loss = softmax_xent(logits[:, :-1], labels[:, 1:])
        if cfg.mtp:
            loss = loss + cfg.mtp_weight * self._mtp_loss(params, x, batch)
        return loss

    def _mtp_loss(self, params, trunk_h, batch) -> torch.Tensor:
        """DeepSeek-V3 multi-token prediction: one extra block predicts
        token ``t+2`` from ``[norm(h_t) ; E(tok_{t+1})]`` (the trunk is
        shared), as the reference, which does not remat this block."""
        tokens, labels = batch["tokens"], batch["labels"]
        b, s, _ = trunk_h.shape
        positions = torch.arange(s - 1, device=trunk_h.device).expand(
            b, s - 1)
        mtp = params["mtp"]
        nxt = embed(params["embed"], tokens[:, 1:])
        h = torch.cat([self._norm(mtp["norm"], trunk_h[:, :-1]), nxt], -1)
        h = dense(mtp["proj"], h)

        def attend(_group, _i, p, x):
            return self._attend_full(p, x, positions)

        h = self._block(attend, "mtp", self.cfg.runs()[-1][1], None,
                        mtp["block"], h)
        logits = self._head(params, h)
        return softmax_xent(logits[:, :-1], labels[:, 2:])

    # --------------------------------------------------------------- serving
    def _kv(self, lead: tuple[int, int], *, device, paged: bool = False
            ) -> Tree:
        """Zero cache per block group, ``[layers, *lead, ...]``: GQA k/v
        ``[..., n_kv, hd]``, MLA latents ``c_kv [..., r_kv]`` and
        ``k_rope [..., rope]``."""
        cfg = self.cfg
        out = {}
        for group, _kind, n in cfg.runs():
            if cfg.mla is not None:
                make = mla_init_paged_cache if paged else mla_init_cache
                one = make(cfg.mla, *lead, cfg.dtype, device=device)
                out[group] = {k: v.expand(n, *v.shape).contiguous()
                              for k, v in one.items()}
            else:
                out[group] = {
                    name: torch.zeros((n, *lead, cfg.n_kv_heads, cfg.hd),
                                      dtype=cfg.dtype, device=device)
                    for name in ("k", "v")}
        return out

    def init_cache(self, batch: int, max_seq: int, *, device) -> Tree:
        return self._kv((batch, max_seq), device=device)

    def prefill(self, params, tokens, cache, *,
                embeds=None) -> tuple[torch.Tensor, Tree]:
        """Write ``tokens``' KV into positions ``[0, s)`` of every lane of
        ``cache`` (in place) and return (last-token logits ``[b, 1,
        vocab]``, cache).  ``embeds [b, n, d]`` (a vision prefix) takes
        positions ``[0, n)`` and the prompt ``[n, n + s)``.

        Prefill always starts at position 0, so its attention is causal
        over ``[0, s)`` — exactly the flash kernel's contract.  The
        reference attends the whole cache lane with positions ``>= s``
        masked, which is the same function.
        """
        cfg = self.cfg
        x = self._embed(params, tokens, embeds)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)

        def attend(group, i, p, h):
            if cfg.mla is not None:      # a full pass, then its latents
                out, fresh = mla_apply_full(p, cfg.mla, h, positions)
                for name, t in fresh.items():
                    cache[group][name][i, :, :s] = t
                return out
            q, k, v = self._project_qkv(p, h, positions)
            cache[group]["k"][i, :, :s] = k
            cache[group]["v"][i, :, :s] = v
            out = flash_attention(q, k, v, causal=True, window=cfg.window)
            return out.reshape(b, s, -1) @ p["wo"]["w"]

        # a prompt's eager layers make thousands of host operations: a
        # span a layer keeps each idle gap of the card near a named range
        for group, kind, n in self.cfg.runs():
            for i in range(n):
                with span("repro_torch.serve.prefill_layer"):
                    x = self._block(attend, group, kind, i,
                                    _layer(params[group], i), x)
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
        if cfg.mla is not None:
            def mla(group, i, p, h):
                return mla_decode(p, cfg.mla, h, _layer(cache[group], i),
                                  pos)[0]

            return self._head(params, self._blocks(params, x, mla)), cache
        b = x.shape[0]
        max_seq = cache["blocks"]["k"].shape[2]
        positions = pos[:, None]
        rows = torch.arange(b, device=x.device)
        # dynamic_update_slice clamps its index into range; so does this
        write = pos.long().clamp(0, max_seq - 1)
        kv_pos = torch.arange(max_seq, device=x.device).expand(b, max_seq)

        def attend(group, i, p, h):
            q, k, v = self._project_qkv(p, h, positions)
            ck, cv = cache[group]["k"], cache[group]["v"]
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
        """Global KV page pool, per block group ``[layers, n_pages,
        page_size, ...]`` (GQA k and v ``[..., n_kv, hd]``, MLA latents);
        page 0 is the pool's trash page."""
        return self._kv((n_pages, page_size), device=device, paged=True)

    def decode_step_paged(self, params, pages, token, pos, block_tables,
                          active, *, attn_scratch=None
                          ) -> tuple[torch.Tensor, Tree]:
        """Slot-batched one-token decode against the page pool.

        ``token [slots, 1]``, ``pos [slots]`` int32 write index,
        ``block_tables [slots, max_blocks]`` int32, ``active [slots]``
        bool (inactive lanes write the trash page).  Each layer writes
        this token's KV into its page (in place), then attends through
        the block table with the paged kernel (``attn_scratch``: the
        caller's own split-K scratch, see
        :func:`~repro_torch.kernels.paged_attention.ops.launch_scratch`).
        MLA writes its latents into the pages and attends their gathered
        stream (:func:`~repro_torch.models.mla.mla_decode_paged`; no
        kernel, no scratch).  Returns (logits ``[slots, 1, vocab]``,
        pages).
        """
        cfg = self.cfg
        x = embed(params["embed"], token)
        if cfg.mla is not None:
            def mla(group, i, p, h):
                return mla_decode_paged(p, cfg.mla, h,
                                        _layer(pages[group], i),
                                        block_tables, pos, active)[0]

            return self._head(params, self._blocks(params, x, mla)), pages
        b = x.shape[0]
        positions = pos[:, None]
        kv_len = pos + 1

        def attend(group, i, p, h):
            q, k, v = self._project_qkv(p, h, positions)
            pk, pv = pages[group]["k"], pages[group]["v"]
            write_token_to_pages(pk[i], block_tables, pos, active, k[:, 0])
            write_token_to_pages(pv[i], block_tables, pos, active, v[:, 0])
            out = paged_attention(q[:, 0], pk[i], pv[i], block_tables,
                                  kv_len, window=cfg.window,
                                  scratch=attn_scratch)
            return out.reshape(b, 1, -1) @ p["wo"]["w"]

        x = self._blocks(params, x, attend)
        return self._head(params, x), pages

    # ------------------------------------------------------------- structure
    def unit_layout(self) -> UnitLayout:
        """Schedulable units in network order: ``embed``, one per layer
        of each block group (numbered across groups), [``mtp``],
        ``head``."""
        entries = [UnitEntry("embed", "embed", None)]
        gi = 0
        for group, _kind, n in self.cfg.runs():
            entries += [UnitEntry(f"layer_{gi + i}", group, i)
                        for i in range(n)]
            gi += n
        if self.cfg.mtp:
            entries.append(UnitEntry("mtp", "mtp", None))
        entries.append(UnitEntry("head", "head", None))
        return UnitLayout(tuple(entries))

    # ---------------------------------------------------- analytic accounting
    def _block_param_count(self, kind: str) -> int:
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.hd
        if cfg.mla is not None:
            attn = mla_param_count(cfg.mla, d)
        else:
            attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) \
                + cfg.n_heads * hd * d
            if cfg.qkv_bias:
                attn += hd * (cfg.n_heads + 2 * cfg.n_kv_heads)
            if cfg.qk_norm:
                attn += 2 * hd
        norms = 2 * d * (2 if cfg.norm_kind == "layernorm" else 1)
        if kind == "moe":
            mlp = moe_param_count(cfg.moe, d)
        else:
            mlp = d * (cfg.dense_d_ff or cfg.d_ff) \
                * (3 if cfg.mlp_kind == "swiglu" else 2)
        return attn + mlp + norms

    def param_count(self) -> int:
        cfg = self.cfg
        n = cfg.vocab * cfg.d_model                       # embed
        for _group, kind, cnt in cfg.runs():
            n += cnt * self._block_param_count(kind)
        if cfg.mtp:
            n += self._block_param_count(cfg.runs()[-1][1]) \
                + 2 * cfg.d_model * cfg.d_model + cfg.d_model
        n += cfg.d_model                                  # final norm
        if not cfg.tie_embeddings:
            n += cfg.d_model * cfg.vocab
        return n

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k + shared only)."""
        cfg = self.cfg
        if cfg.moe is None:
            return self.param_count()
        n = cfg.vocab * cfg.d_model + cfg.d_model
        if not cfg.tie_embeddings:
            n += cfg.d_model * cfg.vocab
        for _group, kind, cnt in cfg.runs():
            per = self._block_param_count(kind)
            if kind == "moe":
                per += moe_active_param_count(cfg.moe, cfg.d_model) \
                    - moe_param_count(cfg.moe, cfg.d_model)
            n += cnt * per
        return n

    def _block_fwd_flops(self, kind: str, tokens: int, seq: int,
                         kv_len: int) -> float:
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.hd
        if cfg.mla is not None:
            attn = mla_fwd_flops(cfg.mla, d, tokens, kv_len)
        else:
            proj = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) \
                + cfg.n_heads * hd * d
            att_len = kv_len if cfg.window is None \
                else min(kv_len, cfg.window)
            attn = 2.0 * tokens * proj \
                + 2.0 * tokens * att_len * cfg.n_heads * hd * 2
        if kind == "moe":
            mlp = moe_fwd_flops(cfg.moe, d, tokens, seq)
        else:
            d_ff = cfg.dense_d_ff or cfg.d_ff
            mlp = 2.0 * tokens * d * d_ff * (3 if cfg.mlp_kind == "swiglu"
                                             else 2)
        return attn + mlp

    def layer_costs(self, batch: int, seq: int, *,
                    mode: str = "train") -> list[tuple[str, float, float]]:
        """(unit_name, n_params, fwd_flops) per unit — profiler input.

        ``mode="decode"`` charges one-token steps against a ``seq``-deep KV
        cache (serving shapes); an MoE block's capacity is charged at
        ``seq`` in both modes, as the reference does.  A dropless held
        MoE block is charged the bytes of the experts it holds and its
        active FLOPs (:func:`~repro_torch.models.moe.moe_fwd_flops`)."""
        cfg = self.cfg
        tokens = batch * seq if mode == "train" else batch
        out = [("embed", float(cfg.vocab * cfg.d_model),
                2.0 * tokens * cfg.d_model)]
        gi = 0
        for _group, kind, cnt in cfg.runs():
            per_p = float(self._block_param_count(kind))
            per_f = self._block_fwd_flops(kind, tokens, seq, seq)
            out += [(f"layer_{gi + i}", per_p, per_f) for i in range(cnt)]
            gi += cnt
        if cfg.mtp:
            kind = cfg.runs()[-1][1]
            d = cfg.d_model
            out.append(("mtp",
                        float(self._block_param_count(kind) + 2 * d * d),
                        self._block_fwd_flops(kind, tokens, seq, seq)
                        + 2.0 * tokens * 2 * d * d))
        head_p = float(cfg.d_model + (0 if cfg.tie_embeddings
                                      else cfg.d_model * cfg.vocab))
        out.append(("head", head_p, 2.0 * tokens * cfg.d_model * cfg.vocab))
        return out
