"""Multi-head Latent Attention (DeepSeek-V2/V3) with absorbed decode.

Counterpart of ``repro.models.mla``, in plain functions on tensors.
Training and prefill expand the compressed KV latent into per-head keys
and values (:func:`mla_apply_full`).  Decode uses the **absorbed** form:
queries are folded through ``W_uk`` so attention runs against the cached
latent ``c_kv [b, s, r_kv]`` itself, and the cache holds ``r_kv + rope``
values a token instead of ``2 * n_heads * head_dim`` (576 against 32768
for V3).  RoPE applies only to the decoupled rope sub-dimensions; the
shared key-rope is broadcast across heads.

Scores are float32, as the reference's ``preferred_element_type``: the
operands are upcast before the contraction (a bfloat16 ``einsum`` would
round the scores to bfloat16).  Masked scores are ``-1e30``; the float32
softmax is cast to the activation dtype before the combine.

Differences from the reference:

* the decode paths write the cache **in place** and each lane at its own
  position (the reference writes every lane at ``pos[0]`` and returns a
  new cache; its engine vmaps a one-lane step over the slots);
* the reference pins the head axis of the expanded keys, values and
  queries to a mesh axis (``maybe_constrain``); one device has no mesh,
  so the port has no such call;
* the query chunks of a long full pass are recomputed in the backward
  pass only when gradients are on (the reference always wraps them in
  ``jax.checkpoint``, which changes no value);
* ``q_lora_rank=None`` projects the queries with one ``w_q`` (Moonlight's
  attention); the reference always has the query LoRA.

No CUDA kernel runs here: the expanded prefill has ``qk_dim`` (192) !=
``v_head_dim`` (128), outside the flash kernel's contract, and the
absorbed decode attends in rank space, where the GQA paged kernel does
not apply.  The MLA paged pool is paged for capacity only: the latent
stream is gathered back to position order and attended by the same
:func:`_absorbed_attend` as the contiguous decode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.paged_attention import gather_pages, write_token_to_pages
from .layers import apply_rope, norm_init, normal, rms_norm, rope_freqs

__all__ = ["MLAConfig", "mla_init", "mla_specs", "mla_apply_full",
           "mla_decode", "mla_init_cache", "mla_init_paged_cache",
           "mla_decode_paged", "mla_param_count", "mla_fwd_flops"]

Tree = Any

_NEG_INF = -1e30


@dataclass(frozen=True)
class MLAConfig:
    n_heads: int = 128
    q_lora_rank: int | None = 1536       # None: queries projected directly
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 1e4

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim


def mla_init(gen: torch.Generator, cfg: MLAConfig, d_model: int, *,
             dtype=torch.bfloat16, stack: tuple = ()) -> Tree:
    """The reference's layout and scales (``w_*`` bare tensors ``[*stack,
    d_in, d_out]``, ``q_norm`` / ``kv_norm`` ``{"scale"}``); the draws
    differ from JAX's.  Without a query LoRA (``q_lora_rank=None``,
    Moonlight's and DeepSeek-V2-Lite's form) one ``w_q [*stack, d_in,
    heads * qk_dim]`` takes the place of ``w_dq`` / ``q_norm`` /
    ``w_uq``."""
    h, rq, rkv = cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank
    s = d_model ** -0.5
    dev = gen.device
    if rq is None:
        q = {"w_q": normal(gen, (*stack, d_model, h * cfg.qk_dim), s, dtype)}
    else:
        q = {"w_dq": normal(gen, (*stack, d_model, rq), s, dtype),
             "q_norm": norm_init(rq, dtype=dtype, stack=stack, device=dev),
             "w_uq": normal(gen, (*stack, rq, h * cfg.qk_dim), rq ** -0.5,
                            dtype)}
    return {
        **q,
        "w_dkv": normal(gen, (*stack, d_model, rkv + cfg.qk_rope_dim), s,
                        dtype),
        "kv_norm": norm_init(rkv, dtype=dtype, stack=stack, device=dev),
        "w_uk": normal(gen, (*stack, rkv, h * cfg.qk_nope_dim), rkv ** -0.5,
                       dtype),
        "w_uv": normal(gen, (*stack, rkv, h * cfg.v_head_dim), rkv ** -0.5,
                       dtype),
        "w_o": normal(gen, (*stack, h * cfg.v_head_dim, d_model),
                      (h * cfg.v_head_dim) ** -0.5, dtype),
    }


def mla_specs(cfg: MLAConfig) -> Tree:
    """Logical axes of :func:`mla_init`'s leaves (one unstacked layer)."""
    if cfg.q_lora_rank is None:
        q = {"w_q": (None, "heads")}
    else:
        q = {"w_dq": (None, None), "q_norm": {"scale": (None,)},
             "w_uq": (None, "heads")}
    return {**q, "w_dkv": (None, None),
            "kv_norm": {"scale": (None,)}, "w_uk": (None, "heads"),
            "w_uv": (None, "heads"), "w_o": ("heads", None)}


def _project_q(p, cfg: MLAConfig, x, positions, inv_freq):
    b, s, _ = x.shape
    if cfg.q_lora_rank is None:
        q = x @ p["w_q"]
    else:
        q = rms_norm(p["q_norm"], x @ p["w_dq"]) @ p["w_uq"]
    q = q.reshape(b, s, cfg.n_heads, cfg.qk_dim)
    q_nope, q_rope = q.split([cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, inv_freq)


def _compress_kv(p, cfg: MLAConfig, x, positions, inv_freq):
    c_kv, k_rope = (x @ p["w_dkv"]).split(
        [cfg.kv_lora_rank, cfg.qk_rope_dim], dim=-1)
    c_kv = rms_norm(p["kv_norm"], c_kv)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, inv_freq)[:, :, 0]
    return c_kv, k_rope                      # [b,s,r_kv], [b,s,rope]


def mla_apply_full(p, cfg: MLAConfig, x: torch.Tensor,
                   positions: torch.Tensor, *,
                   q_chunk: int = 1024) -> tuple[torch.Tensor, dict]:
    """Full-expansion MLA (training / prefill).  Returns (out, the fresh
    latents ``{"c_kv", "k_rope"}``).

    Queries run in ``q_chunk`` blocks, so the score tensor peaks at
    ``[b, h, q_chunk, s]``; with gradients on, each block is recomputed
    in the backward pass instead of keeping its scores."""
    b, s, _ = x.shape
    h = cfg.n_heads
    inv_freq = rope_freqs(cfg.qk_rope_dim, cfg.rope_theta, device=x.device)

    q_nope, q_rope = _project_q(p, cfg, x, positions, inv_freq)
    c_kv, k_rope = _compress_kv(p, cfg, x, positions, inv_freq)

    k_nope = (c_kv @ p["w_uk"]).reshape(b, s, h, cfg.qk_nope_dim)
    v = (c_kv @ p["w_uv"]).reshape(b, s, h, cfg.v_head_dim)
    scale = cfg.qk_dim ** -0.5
    # one score contraction over the concatenated nope + rope sub-dims,
    # the shared key-rope broadcast across heads (the reference's form)
    kq = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, cfg.qk_rope_dim)], dim=-1).float()
    kpm = positions[:, None, None, :]

    def attend(qc: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
        scores = torch.einsum("bqhd,bkhd->bhqk", qc.float(), kq) * scale
        scores = torch.where(kpm <= qp[:, None, :, None], scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)

    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    if s <= q_chunk:
        out = attend(q_cat, positions)
    else:
        remat = torch.is_grad_enabled()
        parts = []
        for i in range(0, s, q_chunk):
            qc, qp = q_cat[:, i:i + q_chunk], positions[:, i:i + q_chunk]
            parts.append(checkpoint(attend, qc, qp, use_reentrant=False,
                                    preserve_rng_state=False)
                         if remat else attend(qc, qp))
        out = torch.cat(parts, dim=1)
    out = out.reshape(b, s, -1)
    return out @ p["w_o"], {"c_kv": c_kv, "k_rope": k_rope}


def mla_init_cache(cfg: MLAConfig, batch: int, max_seq: int, dtype, *,
                   device) -> dict:
    return {
        "c_kv": torch.zeros((batch, max_seq, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_seq, cfg.qk_rope_dim), dtype=dtype,
                              device=device),
    }


def _absorbed_attend(p, cfg: MLAConfig, q_nope, q_rope, c_kv, k_rope,
                     pos, dtype) -> torch.Tensor:
    """Absorbed attention against a latent stream ``c_kv [b, sk, r_kv]``
    / ``k_rope [b, sk, rope]`` with per-lane valid length ``pos + 1``.
    Shared by the contiguous and paged decodes so the two cannot drift:
    queries fold through ``W_uk`` and the combine through ``W_uv``, so
    scores and outputs live in rank space."""
    b = q_nope.shape[0]
    h = cfg.n_heads
    w_uk = p["w_uk"].reshape(cfg.kv_lora_rank, h, cfg.qk_nope_dim)
    q_c = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)        # [b,1,h,r_kv]

    scale = cfg.qk_dim ** -0.5
    scores = (torch.einsum("bqhr,bsr->bhqs", q_c.float(), c_kv.float())
              + torch.einsum("bqhd,bsd->bhqs", q_rope.float(),
                             k_rope.float())) * scale
    sk = c_kv.shape[1]
    valid = torch.arange(sk, device=c_kv.device)[None, None, None, :] \
        <= pos[:, None, None, None]
    scores = torch.where(valid, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dtype)

    o_c = torch.einsum("bhqs,bsr->bqhr", probs, c_kv)          # [b,1,h,r_kv]
    w_uv = p["w_uv"].reshape(cfg.kv_lora_rank, h, cfg.v_head_dim)
    o = torch.einsum("bqhr,rhd->bqhd", o_c, w_uv).reshape(b, 1, -1)
    return o @ p["w_o"]


def mla_decode(p, cfg: MLAConfig, x: torch.Tensor, cache: dict,
               pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Absorbed one-token decode.  ``x [b, 1, d]``; ``cache`` one layer's
    ``{"c_kv": [b, max_seq, r_kv], "k_rope": [b, max_seq, rope]}``,
    written in place, each lane at its own ``pos [b]`` (0-based write
    position = number of valid entries; clamped into range, as
    ``dynamic_update_slice`` clamps).  Returns (out, cache)."""
    inv_freq = rope_freqs(cfg.qk_rope_dim, cfg.rope_theta, device=x.device)
    positions = pos[:, None]

    q_nope, q_rope = _project_q(p, cfg, x, positions, inv_freq)  # [b,1,h,*]
    c_new, kr_new = _compress_kv(p, cfg, x, positions, inv_freq)

    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    rows = torch.arange(x.shape[0], device=x.device)
    write = pos.long().clamp(0, c_kv.shape[1] - 1)
    c_kv[rows, write] = c_new[:, 0].to(c_kv.dtype)
    k_rope[rows, write] = kr_new[:, 0].to(k_rope.dtype)

    out = _absorbed_attend(p, cfg, q_nope, q_rope, c_kv, k_rope, pos,
                           x.dtype)
    return out, cache


def mla_init_paged_cache(cfg: MLAConfig, n_pages: int, page_size: int,
                         dtype, *, device) -> dict:
    """Latent KV page pool (``c_kv`` and the decoupled key-rope)."""
    return mla_init_cache(cfg, n_pages, page_size, dtype, device=device)


def mla_decode_paged(p, cfg: MLAConfig, x: torch.Tensor, pages: dict,
                     block_tables: torch.Tensor, pos: torch.Tensor,
                     active: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Absorbed one-token decode against one layer's paged latent pool.

    ``x [slots, 1, d]``; ``pages`` hold ``c_kv [n_pages, ps, r_kv]`` /
    ``k_rope [n_pages, ps, rope]``, written in place; ``block_tables
    [slots, max_blocks]`` int32 page ids; ``pos [slots]`` per-slot write
    position; ``active [slots]`` gates the write (inactive lanes write
    the trash page 0).  The streams are gathered back to position order
    (static shapes, no host read) and attended as the contiguous decode
    does.  Returns (out, pages)."""
    inv_freq = rope_freqs(cfg.qk_rope_dim, cfg.rope_theta, device=x.device)
    positions = pos[:, None]

    q_nope, q_rope = _project_q(p, cfg, x, positions, inv_freq)
    c_new, kr_new = _compress_kv(p, cfg, x, positions, inv_freq)

    write_token_to_pages(pages["c_kv"], block_tables, pos, active,
                         c_new[:, 0])
    write_token_to_pages(pages["k_rope"], block_tables, pos, active,
                         kr_new[:, 0])
    c_kv = gather_pages(pages["c_kv"], block_tables)          # [b,sk,r_kv]
    k_rope = gather_pages(pages["k_rope"], block_tables)

    out = _absorbed_attend(p, cfg, q_nope, q_rope, c_kv, k_rope, pos,
                           x.dtype)
    return out, pages


# ---------------------------------------------------------------------------
# Analytic accounting, the reference's formulas
# ---------------------------------------------------------------------------

def mla_param_count(cfg: MLAConfig, d_model: int) -> int:
    h = cfg.n_heads
    if cfg.q_lora_rank is None:
        n = d_model * h * cfg.qk_dim                                # q
    else:
        n = d_model * cfg.q_lora_rank + cfg.q_lora_rank             # dq+norm
        n += cfg.q_lora_rank * h * cfg.qk_dim                       # uq
    n += d_model * (cfg.kv_lora_rank + cfg.qk_rope_dim)             # dkv
    n += cfg.kv_lora_rank                                           # kv norm
    n += cfg.kv_lora_rank * h * (cfg.qk_nope_dim + cfg.v_head_dim)  # uk+uv
    n += h * cfg.v_head_dim * d_model                               # o
    return n


def mla_fwd_flops(cfg: MLAConfig, d_model: int, tokens: int,
                  seq_len: int) -> float:
    """Forward FLOPs of full-expansion MLA over ``tokens`` (train/prefill)."""
    h = cfg.n_heads
    proj = mla_param_count(cfg, d_model) - (cfg.q_lora_rank or 0) \
        - cfg.kv_lora_rank                                          # no norms
    flops = 2.0 * tokens * proj                                    # projections
    flops += 2.0 * tokens * seq_len * h * (cfg.qk_dim + cfg.v_head_dim)
    return flops
