"""95th percentile, over every request sent in the window, of (last
token's time - first token's time) / (tokens - 1) on the host; tokens
arrive in decode blocks, so single gaps mean nothing."""

from perfbench.bench import p95


def read(v: dict):
    if not v.get("requests"):
        return None
    return p95([t for _, t in v["requests"]]) * 1e3
