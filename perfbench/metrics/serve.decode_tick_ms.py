"""Milliseconds a decode tick takes: the engine's decode seconds in the
window over the ticks it ran with some lane live."""


def read(v: dict):
    if "requests" not in v or not v["ticks_run"]:
        return None
    return 1e3 * v["decode_time_s"] / v["ticks_run"]
