"""granite-3-2b — IBM Granite 3.0 2B base (dense GQA).

[hf:ibm-granite/granite-3.0-2b-base]: 40 layers, d_model 2048, 32 heads with
GQA kv=8, d_ff 8192 (SwiGLU), vocab 49155, RoPE, RMSNorm, tied embeddings.
Same values as ``repro.configs.granite_3_2b``.
"""

from ..models.transformer import DecoderLM, LMConfig
from .common import ArchSpec

CONFIG = LMConfig(
    name="granite-3-2b",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=49155,
    head_dim=64,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=10_000.0,
    tie_embeddings=True,
)

SMOKE = LMConfig(
    name="granite-smoke",
    n_layers=4,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    head_dim=8,
    tie_embeddings=True,
    param_dtype="float32",
)

ARCH = ArchSpec(
    arch_id="granite-3-2b",
    family="dense",
    make_model=lambda: DecoderLM(CONFIG),
    make_smoke=lambda: DecoderLM(SMOKE),
    large=False,
    optimizer="adamw",
    sub_quadratic=False,
    notes="GQA dense baseline",
)
