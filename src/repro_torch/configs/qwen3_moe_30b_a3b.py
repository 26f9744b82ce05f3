"""qwen3-moe-30b-a3b — Qwen3-30B-A3B (MoE, 128 experts top-8).

[hf:Qwen/Qwen3-30B-A3B]: 48 layers, d_model 2048, 32 heads with GQA kv=4
(head_dim 128), per-expert d_ff 768, 128 experts top-8 (softmax router,
renormalized), vocab 151936, qk_norm, untied.  Same values as
``repro.configs.qwen3_moe_30b_a3b``.
"""

from ..models.moe import MoEConfig
from ..models.transformer import DecoderLM, LMConfig
from .common import ArchSpec

CONFIG = LMConfig(
    name="qwen3-moe-30b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,                      # per-expert hidden (assigned spec)
    vocab=151_936,
    head_dim=128,
    qk_norm=True,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff=768, n_shared=0,
                  capacity_factor=1.25, router="softmax"),
)

SMOKE = LMConfig(
    name="qwen3-moe-smoke",
    n_layers=3,
    d_model=32,
    n_heads=4,
    n_kv_heads=2,
    d_ff=48,
    vocab=256,
    head_dim=8,
    qk_norm=True,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=48, capacity_factor=1.25),
    param_dtype="float32",
)

ARCH = ArchSpec(
    arch_id="qwen3-moe-30b-a3b",
    family="moe",
    make_model=lambda: DecoderLM(CONFIG),
    make_smoke=lambda: DecoderLM(SMOKE),
    large=True,
    optimizer="adafactor",
    sub_quadratic=False,
    notes="dense one-hot dispatch: every expert computes on its capacity "
          "slots, so a decode tick reads every expert",
)
