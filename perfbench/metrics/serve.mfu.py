"""The serving loop's share of the card's bf16 peak: the frozen FLOPs of
the prompts prefilled and the tokens decoded in the window (each at the
keys it read) over the window's seconds (host clock)."""

from perfbench.costs import PEAK_FLOPS, decode_flops, prefill_flops


def read(v: dict):
    if "requests" not in v:
        return None
    m = v["model"]
    flops = sum(prefill_flops(m, n) for n in v["prompts"]) \
        + sum(decode_flops(m, k) for k in v["kv_lens"])
    return 100.0 * flops / v["window_s"] / PEAK_FLOPS["bfloat16"]
