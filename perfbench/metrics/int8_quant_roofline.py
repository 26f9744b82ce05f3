"""The share of its roofline reached by the int8 row kernels (quantize and
dequantize) at the shapes the captured period holds: each launch over
``[rows, cols]`` moves its float32 and int8 elements and row scales once
(5 operations an element to quantize, 1 to dequantize); the least time
those operations and bytes need (the larger of FLOPs at the float32 peak
and bytes at 3.35 TB/s) over the kernels' device time in the profiled
period (device trace). Nothing when the slice ran no such kernel."""

from perfbench.costs import bound_s
from perfbench.trace import kernel_seconds

KERNELS = ("quantize_rows", "dequantize_rows")


def work(rows: int, cols: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one quantize and one dequantize launch."""
    n = rows * cols
    return 5.0 * n + 1.0 * n, 2 * (n * 5 + rows * 4)


def read(v: dict):
    shapes = v.get("slice", {}).get("int8_shapes")
    if not shapes or "kernels" not in v:
        return None
    launches, seconds = kernel_seconds(v["kernels"], KERNELS)
    if not launches:
        return None
    each = [(n, *work(r, c)) for r, c, n in shapes]
    return 100.0 * bound_s(sum(n * f for n, f, _ in each),
                           sum(n * b for n, _, b in each),
                           "float32") / seconds
