"""Every worker's tokens in the whole periods the window completed, over
the time from the window's start to the end of the last of them (host
clock, each period ending in a device synchronize)."""


def read(v: dict):
    if "steps" not in v:
        return None
    return v["tokens"] / v["window_s"]
