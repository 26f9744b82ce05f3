"""The share of its roofline reached by the grouped expert products over
the profiled period: each launch of a layout over the rows its (worker,
layer, step) routed to the held experts does 2 rows K N operations and
moves the G held experts' weights (or, in wgrad, their gradients) once
and its rows in and out once (bf16); the rows of every launch of one
kind add up to the period's routed rows (the program's counter) times
that kind's launches a layer call.  The least time those operations and
bytes need (the larger of FLOPs at the bf16 peak and bytes at 3.35
TB/s) over the kernel's device time (device trace).  Nothing when the
slice ran no such kernel."""

from perfbench.costs import bound_s
from perfbench.trace import kernel_seconds

KERNELS = ("grouped_gemm",)


def work(K: int, N: int, G: int, rows: float, launches: int,
         es: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) of ``launches`` launches of one kind over ``rows``
    rows in all."""
    return 2.0 * rows * K * N, es * (launches * G * K * N + rows * (K + N))


def read(v: dict):
    sl = v.get("slice", {})
    if "launches" not in sl or "kernels" not in v:
        return None
    n, seconds = kernel_seconds(v["kernels"], KERNELS)
    if not n or not sl["layer_calls"]:
        return None
    each = [work(K, N, sl["groups"],
                 sl["routed_rows"] * launches / sl["layer_calls"], launches)
            for _, K, N, launches in sl["launches"]]
    return 100.0 * bound_s(sum(f for f, _ in each), sum(b for _, b in each),
                           "bfloat16") / seconds
