"""Hand-written CUDA kernels for Hopper (``sm_90a``) on the serving path.

flash_attention  blockwise causal GQA attention forward (prefill)
paged_attention  block-table decode attention over a paged KV pool
                 (serve engine ``kv_backend="paged"`` decode)

Each kernel package holds ``ref.py`` (the plain PyTorch version, the CPU
path and the oracle) and ``ops.py`` (the wrapper that launches the CUDA
kernel from ``csrc/`` for CUDA tensors).  ``_build`` compiles ``csrc/``
with ``nvcc`` on first use.
"""
