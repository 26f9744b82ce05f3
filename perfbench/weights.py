"""Weights drawn on the device from the run's seed, in a few large calls.

One ``torch.Generator`` per leaf, seeded from ``(seed, leaf index)``, so
the reference can draw any leaf again, alone and in the same values,
after the program has been freed.  The scales are the published
configuration's own initialisation: ``N(0, initializer_range^2)`` for
the embedding table and every projection, ones for the norm scales.  (A
table of ``N(0, 1)`` rows, tied to the head, would make each position's
own token win its logit by ``sqrt(d)`` standard deviations, and greedy
decoding would repeat it whatever the precision.)

Plain PyTorch; imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch


def leaf_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for leaf ``index`` of the run ``seed``."""
    state = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def dense_leaves(m: dict) -> list[tuple[str, tuple, float | None]]:
    """(dotted path, shape, init scale; ``None`` for ones) of every leaf
    of a dense decoder in the program's parameter layout: ``embed``, the
    ``blocks`` group stacked ``[layers, ...]``, ``head``."""
    d, hd, L = m["d_model"], m["head_dim"], m["n_layers"]
    nq, nkv, ff, v = m["n_heads"] * hd, m["n_kv_heads"] * hd, m["d_ff"], m["vocab"]
    s = m["init_std"]
    leaves = [
        ("embed.table", (v, d), s),
        ("blocks.ln1.scale", (L, d), None),
        ("blocks.attn.wq.w", (L, d, nq), s),
        ("blocks.attn.wk.w", (L, d, nkv), s),
        ("blocks.attn.wv.w", (L, d, nkv), s),
        ("blocks.attn.wo.w", (L, nq, d), s),
        ("blocks.ln2.scale", (L, d), None),
        ("blocks.mlp.gate.w", (L, d, ff), s),
        ("blocks.mlp.up.w", (L, d, ff), s),
        ("blocks.mlp.down.w", (L, ff, d), s),
        ("head.norm.scale", (d,), None),
    ]
    if not m["tie"]:
        leaves.append(("head.out.w", (d, v), s))
    return leaves


def draw_leaf(m: dict, seed: int, index: int, device,
              dtype: torch.dtype) -> torch.Tensor:
    """Leaf ``index`` of :func:`dense_leaves`, drawn as the run draws it."""
    _, shape, scale = dense_leaves(m)[index]
    if scale is None:
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device).manual_seed(leaf_seed(seed, index))
    x = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return x.mul_(scale)


def nest(flat: dict) -> dict:
    """``{"a.b.c": t}`` -> ``{"a": {"b": {"c": t}}}``."""
    out: dict = {}
    for path, t in flat.items():
        node = out
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return out


def flatten(tree: dict, prefix: str = "") -> dict:
    """``{"a": {"b": t}}`` -> ``{"a.b": t}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def dense_params(m: dict, seed: int, device, dtype: torch.dtype) -> dict:
    """Every leaf of :func:`dense_leaves`, as a nested tree."""
    return nest({path: draw_leaf(m, seed, i, device, dtype)
                 for i, (path, _, _) in enumerate(dense_leaves(m))})
