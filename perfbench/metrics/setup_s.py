"""Seconds from the process's start to the window's start: loading,
weights, warm-up, graph captures (host clock)."""


def read(v: dict):
    return v.get("setup_s")
