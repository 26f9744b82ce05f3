"""The share of its roofline reached by the fused AdamW kernel over the
profiled period: one launch a leaf a step over every worker's elements,
each reading and writing p, m and v and reading g (15 operations an
element); the least time those operations and bytes need (the larger of
FLOPs at the float32 peak and bytes at 3.35 TB/s) over the kernel's
device time (device trace). Nothing when the slice ran no such kernel."""

import math

from perfbench.costs import DTYPE_BYTES, bound_s
from perfbench.trace import kernel_seconds

KERNELS = ("fused_adamw",)


def work(n: int, p_bytes: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one launch over ``n`` elements."""
    return 15.0 * n, n * (2 * p_bytes + 5 * 4)


def read(v: dict):
    sl = v.get("slice", {})
    if "adamw_leaves" not in sl or "kernels" not in v:
        return None
    launches, seconds = kernel_seconds(v["kernels"], KERNELS)
    if not launches:
        return None
    p_bytes = DTYPE_BYTES[sl["param_dtype"]]
    each = [work(math.prod(s), p_bytes) for s in sl["adamw_leaves"]]
    flops = sl["steps"] * sum(f for f, _ in each)
    nbytes = sl["steps"] * sum(b for _, b in each)
    return 100.0 * bound_s(flops, nbytes, "float32") / seconds
