"""The share of its roofline reached by the flash kernel over the prompts
prefilled in the profiled slice, each at its own length, in every layer:
QK and PV over the causal pairs, q, k and v read once and the output
written once; the least time those operations and bytes need (the larger
of FLOPs at the bfloat16 peak and bytes at 3.35 TB/s) over the kernel's
device time (device trace). Nothing when the slice ran no such kernel."""

from perfbench.costs import bound_s
from perfbench.trace import kernel_seconds

KERNELS = ("flash_bf16", "flash_f32", "flash_attention")


def work(m: dict, length: int, es: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) of one causal prompt of ``length`` in one layer."""
    pairs = length * (length + 1) // 2
    flops = 4.0 * m["n_heads"] * m["head_dim"] * pairs
    nbytes = length * m["head_dim"] * (2 * m["n_heads"]
                                       + 2 * m["n_kv_heads"]) * es
    return flops, nbytes


def read(v: dict):
    prompts = v.get("slice", {}).get("prompts")
    if not prompts or "kernels" not in v:
        return None
    launches, seconds = kernel_seconds(v["kernels"], KERNELS)
    if not launches:
        return None
    m = v["model"]
    each = [work(m, n) for n in prompts]
    return 100.0 * bound_s(m["n_layers"] * sum(f for f, _ in each),
                           m["n_layers"] * sum(b for _, b in each),
                           "bfloat16") / seconds
