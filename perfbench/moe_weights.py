"""Weights of an MLA + MoE decoder (DeepSeek-V3's block without query
LoRA: Moonlight's) drawn on the device from the run's seed, leaf by leaf,
as :mod:`perfbench.weights` draws a dense decoder's.

The leaves are in the program's parameter layout: ``embed``, a
``dense_blocks`` group of the leading dense layers and a ``blocks`` group
of the MoE layers, each stacked ``[layers, ...]``, and ``head``.  An MoE
layer holds the router over every expert (float32), the held experts'
``gate`` / ``up`` ``[held, d, f]`` and ``down`` ``[held, f, d]``, and the
shared experts as one SwiGLU of width ``n_shared * f``.  Scales: the
published ``initializer_range`` for every projection, the router and the
table; ones for the norm scales.

Plain PyTorch; imports nothing of the program.
"""

from __future__ import annotations

import torch

from .weights import flatten, leaf_seed, nest

__all__ = ["moe_leaves", "draw_moe_leaf", "moe_params", "flatten", "nest"]


def _attn(group: str, L: int, m: dict) -> list:
    d, h, s = m["d_model"], m["n_heads"], m["init_std"]
    r, nope, rope, vd = (m["kv_lora_rank"], m["qk_nope_dim"],
                         m["qk_rope_dim"], m["v_head_dim"])
    a = f"{group}.attn."
    return [(a + "w_q", (L, d, h * (nope + rope)), s, False),
            (a + "w_dkv", (L, d, r + rope), s, False),
            (a + "kv_norm.scale", (L, r), None, False),
            (a + "w_uk", (L, r, h * nope), s, False),
            (a + "w_uv", (L, r, h * vd), s, False),
            (a + "w_o", (L, h * vd, d), s, False)]


def moe_leaves(m: dict) -> list[tuple[str, tuple, float | None, bool]]:
    """(dotted path, shape, init scale or ``None`` for ones, float32 in
    any run) of every leaf, in the order the run draws them."""
    d, s, v = m["d_model"], m["init_std"], m["vocab"]
    Ld, Lm = m["n_dense_layers"], m["n_layers"] - m["n_dense_layers"]
    held, f, fs = m["experts_held"][1], m["expert_ff"], \
        m["n_shared"] * m["expert_ff"]
    leaves = [("embed.table", (v, d), s, False)]
    if Ld:
        g = "dense_blocks."
        leaves += [(g + "ln1.scale", (Ld, d), None, False),
                   *_attn("dense_blocks", Ld, m),
                   (g + "ln2.scale", (Ld, d), None, False),
                   (g + "mlp.gate.w", (Ld, d, m["dense_ff"]), s, False),
                   (g + "mlp.up.w", (Ld, d, m["dense_ff"]), s, False),
                   (g + "mlp.down.w", (Ld, m["dense_ff"], d), s, False)]
    g = "blocks."
    leaves += [(g + "ln1.scale", (Lm, d), None, False),
               *_attn("blocks", Lm, m),
               (g + "ln2.scale", (Lm, d), None, False),
               (g + "mlp.router.w", (Lm, d, m["n_experts"]), s, True),
               (g + "mlp.gate", (Lm, held, d, f), s, False),
               (g + "mlp.up", (Lm, held, d, f), s, False),
               (g + "mlp.down", (Lm, held, f, d), s, False),
               (g + "mlp.shared.gate.w", (Lm, d, fs), s, False),
               (g + "mlp.shared.up.w", (Lm, d, fs), s, False),
               (g + "mlp.shared.down.w", (Lm, fs, d), s, False),
               ("head.norm.scale", (d,), None, False)]
    if not m["tie"]:
        leaves.append(("head.out.w", (d, v), s, False))
    return leaves


def draw_moe_leaf(m: dict, seed: int, index: int, device,
                  dtype: torch.dtype) -> torch.Tensor:
    """Leaf ``index`` of :func:`moe_leaves` (float32 where the leaf says
    so, else ``dtype``), drawn as the run draws it."""
    _, shape, scale, f32 = moe_leaves(m)[index]
    dtype = torch.float32 if f32 else dtype
    if scale is None:
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device).manual_seed(leaf_seed(seed, index))
    x = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return x.mul_(scale)


def moe_params(m: dict, seed: int, device, dtype: torch.dtype) -> dict:
    """Every leaf of :func:`moe_leaves`, as a nested tree."""
    return nest({path: draw_moe_leaf(m, seed, i, device, dtype)
                 for i, (path, _, _, _) in enumerate(moe_leaves(m))})
