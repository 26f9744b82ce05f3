"""The share of the profiled steps of the loop in which no operation ran
on the card (device trace)."""


def read(v: dict):
    if "requests" not in v or "busy_s" not in v:
        return None
    return 100.0 * (1.0 - v["busy_s"] / v["trace_window_s"])
