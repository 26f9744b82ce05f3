"""95th percentile, over every request that arrived in the window, of
its wait from arrival to a slot (the engine's ``Completion.queue_s``); a
request that did not finish counts with the time it waited."""

from perfbench.bench import p95


def read(v: dict):
    if not v.get("queue_s"):
        return None
    return p95(v["queue_s"]) * 1e3
