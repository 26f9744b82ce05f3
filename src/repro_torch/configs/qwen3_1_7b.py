"""qwen3-1.7b — Qwen3-1.7B (dense GQA with qk_norm).

[hf:Qwen/Qwen3-1.7B]: 28 layers, d_model 2048, 16 heads with GQA kv=8,
d_ff 6144, vocab 151936, per-head q/k RMSNorm, head_dim 128, tied.  Same
values as ``repro.configs.qwen3_1_7b``.
"""

from ..models.transformer import DecoderLM, LMConfig
from .common import ArchSpec

CONFIG = LMConfig(
    name="qwen3-1.7b",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab=151_936,
    head_dim=128,
    qk_norm=True,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = LMConfig(
    name="qwen3-smoke",
    n_layers=3,
    d_model=48,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab=384,
    head_dim=16,
    qk_norm=True,
    tie_embeddings=True,
    param_dtype="float32",
)

ARCH = ArchSpec(
    arch_id="qwen3-1.7b",
    family="dense",
    make_model=lambda: DecoderLM(CONFIG),
    make_smoke=lambda: DecoderLM(SMOKE),
    large=False,
    optimizer="adamw",
    sub_quadratic=False,
    notes="qk_norm GQA",
)
