"""95th percentile, over every request sent in the window, of the time
from the client's send to its first token on the host; a request that
failed counts with the time it waited.  Unbounded: it swings with how
many prompts a step admits together, and the prefills that delay a first
token stall every live lane's next tokens too."""

from perfbench.bench import p95


def read(v: dict):
    if not v.get("requests"):
        return None
    return p95([t for t, _ in v["requests"]]) * 1e3
