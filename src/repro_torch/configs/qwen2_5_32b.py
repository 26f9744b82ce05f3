"""qwen2.5-32b — Qwen2.5-32B (dense GQA with QKV bias).

[hf:Qwen/Qwen2.5-32B]: 64 layers, d_model 5120, 40 heads with GQA kv=8,
d_ff 27648, vocab 152064, QKV bias, untied embeddings.  Same values as
``repro.configs.qwen2_5_32b``.
"""

from ..models.transformer import DecoderLM, LMConfig
from .common import ArchSpec

CONFIG = LMConfig(
    name="qwen2.5-32b",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab=152_064,
    head_dim=128,
    qkv_bias=True,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

SMOKE = LMConfig(
    name="qwen2.5-smoke",
    n_layers=3,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=192,
    vocab=512,
    head_dim=8,
    qkv_bias=True,
    param_dtype="float32",
)

ARCH = ArchSpec(
    arch_id="qwen2.5-32b",
    family="dense",
    make_model=lambda: DecoderLM(CONFIG),
    make_smoke=lambda: DecoderLM(SMOKE),
    large=False,
    optimizer="adafactor",
    sub_quadratic=False,
    notes="QKV bias, untied head",
)
