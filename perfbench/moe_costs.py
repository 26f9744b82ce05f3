"""The yardstick's arithmetic for an MLA + MoE decoder (Moonlight's
block), frozen here so that a change to the program cannot move it: each
schedulable unit's parameters and forward FLOPs, and the active FLOPs of
a training step.

Active FLOPs count what the published model computes for the tokens at
hand: every projection of the attention (the expanded MLA: ``w_q``,
``w_dkv``, ``w_uk``, ``w_uv``, ``w_o``), the scores and values over the
whole length (as :func:`perfbench.costs.train_flops_per_step` counts a
dense decoder's), the dense layers' SwiGLU, the router over every expert,
the held experts' SwiGLU over the expected routed rows (``tokens * top_k
* held / n_experts``: a chip's share), the shared experts and the head.
Backward is twice the forward; recomputation is not counted.

Plain Python; imports nothing of the program.
"""

from __future__ import annotations

__all__ = ["unit_costs", "train_flops_per_step", "expert_rows"]


def _mla(m: dict, tokens: int, seq: int) -> tuple[float, float]:
    """(parameters, forward FLOPs) of one expanded MLA without query
    LoRA, its kv norm counted among the parameters only."""
    d, h = m["d_model"], m["n_heads"]
    r, nope, rope, vd = (m["kv_lora_rank"], m["qk_nope_dim"],
                         m["qk_rope_dim"], m["v_head_dim"])
    qk = nope + rope
    proj = d * h * qk + d * (r + rope) + r * h * (nope + vd) + h * vd * d
    flops = 2.0 * tokens * proj + 2.0 * tokens * seq * h * (qk + vd)
    return proj + r, flops


def expert_rows(m: dict) -> float:
    """Routed rows a token gives the held experts, expected: ``top_k *
    held / n_experts``."""
    return m["top_k"] * m["experts_held"][1] / m["n_experts"]


def unit_costs(m: dict, batch: int, seq: int) -> list[tuple[float, float]]:
    """(parameters, forward FLOPs of one worker's ``batch x seq`` tokens)
    of every unit in network order: the embedding, each layer (the
    leading dense ones first), the head.  A layer's parameters are the
    ones a chip holds: its held experts, the whole router."""
    d, v = m["d_model"], m["vocab"]
    tokens = batch * seq
    mla_p, mla_f = _mla(m, tokens, seq)
    dense_p = mla_p + 3 * d * m["dense_ff"] + 2 * d
    dense_f = mla_f + 2.0 * tokens * d * m["dense_ff"] * 3
    f, e = m["expert_ff"], m["n_experts"]
    moe_p = mla_p + (d * e + 3 * m["experts_held"][1] * d * f
                     + 3 * m["n_shared"] * d * f) + 2 * d
    moe_f = mla_f + (2.0 * tokens * d * e
                     + 2.0 * tokens * expert_rows(m) * d * f * 3
                     + 2.0 * tokens * d * (m["n_shared"] * f) * 3)
    n_dense = m["n_dense_layers"]
    head_p = d + (0 if m["tie"] else d * v)
    return ([(float(v * d), 2.0 * tokens * d)]
            + [(float(dense_p), dense_f)] * n_dense
            + [(float(moe_p), moe_f)] * (m["n_layers"] - n_dense)
            + [(float(head_p), 2.0 * tokens * d * v)])


def train_flops_per_step(m: dict, workers: int, batch: int, seq: int
                         ) -> float:
    """Active FLOPs of one step of every worker: three times the
    forward of every layer and the head (the embedding is a lookup)."""
    units = unit_costs(m, batch, seq)
    return 3.0 * workers * sum(f for _, f in units[1:])
