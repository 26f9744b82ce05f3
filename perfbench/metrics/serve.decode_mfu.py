"""Decode's share of the card's bf16 peak: the frozen FLOPs of the
tokens decoded in the window (each at the keys it read) over the
engine's decode seconds, which end in each block's readback."""

from perfbench.costs import PEAK_FLOPS, decode_flops


def read(v: dict):
    if "requests" not in v or not v["decode_time_s"]:
        return None
    flops = sum(decode_flops(v["model"], k) for k in v["kv_lens"])
    return 100.0 * flops / v["decode_time_s"] / PEAK_FLOPS["bfloat16"]
