"""The MoE training step's share of the card's bf16 peak: the frozen
active FLOPs of the steps the window ran (:mod:`perfbench.moe_costs`:
every worker, forward and backward, the held experts at their expected
routed rows) over the window's seconds (host clock)."""

from perfbench.costs import PEAK_FLOPS
from perfbench.moe_costs import train_flops_per_step


def read(v: dict):
    if "steps" not in v or "expert_rows" not in v:
        return None
    flops = v["steps"] * train_flops_per_step(v["model"], v["workers"],
                                              v["batch"], v["seq"])
    return 100.0 * flops / v["window_s"] / PEAK_FLOPS["bfloat16"]
