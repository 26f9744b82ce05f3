"""Prefill's share of the card's bf16 peak: the frozen FLOPs of the
prompts admitted in the window over the engine's prefill seconds, which
end in the host read of their first tokens."""

from perfbench.costs import PEAK_FLOPS, prefill_flops


def read(v: dict):
    if "requests" not in v or not v["prefill_time_s"]:
        return None
    flops = sum(prefill_flops(v["model"], n) for n in v["prompts"])
    return 100.0 * flops / v["prefill_time_s"] / PEAK_FLOPS["bfloat16"]
