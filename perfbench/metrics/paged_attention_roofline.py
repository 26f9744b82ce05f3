"""The share of its roofline reached by the paged kernel over the keys each
live lane read in the profiled slice's ticks, in every layer: q read and
the output written, the K and V of those keys, the lane's block-table
entries and its length; the least time those operations and bytes need
(the larger of FLOPs at the bfloat16 peak and bytes at 3.35 TB/s) over
the kernel's device time (device trace). Nothing when the slice ran no
such kernel."""

import math

from perfbench.costs import bound_s
from perfbench.trace import kernel_seconds

KERNELS = ("paged_attention",)


def work(m: dict, kv_len: int, page: int, es: int = 2
         ) -> tuple[float, float]:
    """(FLOPs, bytes) of one live lane at ``kv_len`` keys in one layer."""
    hd = m["head_dim"]
    flops = 4.0 * m["n_heads"] * hd * kv_len
    nbytes = 2 * m["n_heads"] * hd * es + 2 * kv_len * m["n_kv_heads"] \
        * hd * es + 4 * math.ceil(kv_len / page) + 4
    return flops, nbytes


def read(v: dict):
    kv_lens = v.get("slice", {}).get("kv_lens")
    if not kv_lens or "kernels" not in v:
        return None
    launches, seconds = kernel_seconds(v["kernels"], KERNELS)
    if not launches:
        return None
    m, page = v["model"], v["slice"]["page_size"]
    each = [work(m, k, page) for k in kv_lens]
    return 100.0 * bound_s(m["n_layers"] * sum(f for f, _ in each),
                           m["n_layers"] * sum(b for _, b in each),
                           "bfloat16") / seconds
