"""The most rows any held expert of any layer took in one worker's step
of the window, over the mean rows a held expert took in a worker's step
(the program's device counters, read after the window): 1 is an even
load; the grouped products' time follows the most loaded expert."""


def read(v: dict):
    er = v.get("expert_rows")
    if not er or not er["total"]:
        return None
    mean = er["total"] / (er["worker_steps"] * er["experts"])
    return er["peak"] / mean
