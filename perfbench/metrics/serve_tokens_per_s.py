"""Generated tokens harvested in the window over the window's seconds
(host clock, each step ending in the host read of its tokens)."""


def read(v: dict):
    if "requests" not in v:
        return None
    return v["tokens"] / v["window_s"]
