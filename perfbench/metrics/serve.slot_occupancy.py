"""Live slot-ticks over all slot-ticks of the decode ticks the window
ran (the engine's counters)."""


def read(v: dict):
    if "requests" not in v or not v["slot_ticks_total"]:
        return None
    return 100.0 * v["slot_ticks_active"] / v["slot_ticks_total"]
