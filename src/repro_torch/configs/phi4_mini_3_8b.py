"""phi4-mini-3.8b — Microsoft Phi-4-mini (dense GQA, RoPE, SwiGLU).

[arXiv:2412.08905]: 32 layers, d_model 3072, 24 heads with GQA kv=8,
d_ff 8192, vocab 200064 (o200k), tied embeddings.  Same values as
``repro.configs.phi4_mini_3_8b``.
"""

from ..models.transformer import DecoderLM, LMConfig
from .common import ArchSpec

CONFIG = LMConfig(
    name="phi4-mini-3.8b",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=200_064,
    head_dim=128,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=10_000.0,
    tie_embeddings=True,
)

SMOKE = LMConfig(
    name="phi4-smoke",
    n_layers=3,
    d_model=48,
    n_heads=6,
    n_kv_heads=2,
    d_ff=128,
    vocab=640,
    head_dim=8,
    tie_embeddings=True,
    param_dtype="float32",
)

ARCH = ArchSpec(
    arch_id="phi4-mini-3.8b",
    family="dense",
    make_model=lambda: DecoderLM(CONFIG),
    make_smoke=lambda: DecoderLM(SMOKE),
    large=False,
    optimizer="adamw",
    sub_quadratic=False,
    notes="24 q-heads over 8 kv-heads (GQA group 3)",
)
