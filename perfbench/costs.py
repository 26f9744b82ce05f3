"""The yardstick's arithmetic, frozen here so that a change to the program
cannot move it: the H100's published peaks, the FLOPs of a training step
and of served tokens, and the classes of device operations.  Each
hand-written kernel's operations and bytes live in its roofline reader
under ``metrics/``.

Plain Python; imports nothing of the program.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time the card could take: operations at the peak of
    ``dtype`` or bytes at the HBM rate, whichever is longer."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


# ----------------------------------------------------------------- models

def dense_param_count(m: dict) -> int:
    """Parameters of a dense GQA decoder (SwiGLU, RMSNorm, no biases)
    with ``m`` the harness's model sizes (``n_layers``, ``d_model``,
    ``n_heads``, ``n_kv_heads``, ``head_dim``, ``d_ff``, ``vocab``,
    ``tie``)."""
    d, hd = m["d_model"], m["head_dim"]
    attn = d * hd * (m["n_heads"] + 2 * m["n_kv_heads"]) + m["n_heads"] * hd * d
    block = attn + 3 * d * m["d_ff"] + 2 * d
    head = d + (0 if m["tie"] else d * m["vocab"])
    return m["vocab"] * d + m["n_layers"] * block + head


def train_flops_per_step(m: dict, workers: int, batch: int, seq: int
                         ) -> float:
    """One step of every worker: 6 N per token (forward and backward of
    every parameter) plus the attention products (QK and PV over the
    full length, forward and backward); recomputation under remat is not
    counted."""
    tokens = workers * batch * seq
    attn = 3 * 2.0 * tokens * seq * m["n_heads"] * m["head_dim"] * 2 \
        * m["n_layers"]
    return 6.0 * dense_param_count(m) * tokens + attn


def matmul_params(m: dict) -> int:
    """Weights a served token multiplies: every block weight and the
    output head (the tied table read as the head), not the embedding
    lookup."""
    return dense_param_count(m) - m["vocab"] * m["d_model"] * (
        0 if m["tie"] else 1) - m["d_model"] * (m["n_layers"] * 2 + 1)


def attn_flops(m: dict, keys: float) -> float:
    """QK and PV products of one query over ``keys`` keys in every
    layer."""
    return 4.0 * keys * m["n_heads"] * m["head_dim"] * m["n_layers"]


def prefill_flops(m: dict, length: int) -> float:
    """Forward FLOPs of a causal prompt of ``length`` tokens."""
    return 2.0 * matmul_params(m) * length \
        + attn_flops(m, length * (length + 1) / 2)


def decode_flops(m: dict, kv_len: int) -> float:
    """Forward FLOPs of one decoded token that attends ``kv_len`` keys."""
    return 2.0 * matmul_params(m) + attn_flops(m, kv_len)


# ------------------------------------------------------------ kernel class

def kernel_class(name: str, kernels: dict[str, tuple[str, ...]]) -> str:
    """A device operation's class by its name: the hand-written kernel of
    ``kernels`` (class -> name keys, from the roofline readers) whose key
    it holds, else its kind (the union of the program's serve and train
    profile classes)."""
    low = name.lower()
    for cls, keys in kernels.items():
        if any(k in low for k in keys):
            return cls
    if any(s in low for s in ("gemm", "gemv", "nvjet", "xmma", "cutlass",
                              "cublas")):
        return "matmul"
    if "softmax" in low:
        return "softmax"
    if "memcpy" in low or "memset" in low or "copy" in low:
        return "copies and casts"
    if "reduce" in low:
        return "reductions"
    return "other elementwise"
