"""Hand-written CUDA kernels for Hopper (``sm_90a``).

flash_attention  blockwise causal GQA attention forward (serving prefill)
paged_attention  block-table decode attention over a paged KV pool
                 (serve engine ``kv_backend="paged"`` decode)
fused_adam_sync  one streaming AdamW pass per leaf (training: the
                 ``adam`` / ``adamw`` optimizer update)
int8_quant       per-row int8 quantize / dequantize (training: the
                 ``dreamddp-int8`` sync's wire format)
ssd_scan         Mamba-2 SSD chunk-local core (serving prefill of the
                 Mamba-2 family: the intra-chunk outputs and chunk states)

Each kernel package holds ``ref.py`` (the plain PyTorch version, the CPU
path and the oracle) and ``ops.py`` (the wrapper that launches the CUDA
kernel from ``csrc/`` for CUDA tensors).  ``_build`` compiles ``csrc/``
with ``nvcc`` on first use.
"""

from .. import device  # noqa: F401  (no TF32 in the plain versions)
