"""The training step's share of the card's bf16 peak: the frozen FLOPs
of the steps the window ran (6 N a token and the attention products,
every worker) over the window's seconds (host clock)."""

from perfbench.costs import PEAK_FLOPS, train_flops_per_step


def read(v: dict):
    if "steps" not in v:
        return None
    flops = v["steps"] * train_flops_per_step(v["model"], v["workers"],
                                              v["batch"], v["seq"])
    return 100.0 * flops / v["window_s"] / PEAK_FLOPS["bfloat16"]
