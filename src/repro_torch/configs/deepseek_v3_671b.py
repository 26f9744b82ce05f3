"""deepseek-v3-671b — DeepSeek-V3 (MLA + 256-expert MoE + MTP).

[arXiv:2412.19437]: 61 layers, d_model 7168; MLA with 128 heads
(q_lora 1536, kv_lora 512, qk_nope 128, qk_rope 64, v 128); first 3 layers
dense (d_ff 18432), remaining 58 MoE with 1 shared + 256 routed experts
top-8 (sigmoid router, routed scale 2.5), per-expert d_ff 2048 (assigned
spec); vocab 129280; one MTP module.  Same values as
``repro.configs.deepseek_v3_671b``.
"""

from ..models.mla import MLAConfig
from ..models.moe import MoEConfig
from ..models.transformer import DecoderLM, LMConfig
from .common import ArchSpec

CONFIG = LMConfig(
    name="deepseek-v3-671b",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,                     # per-expert hidden (assigned spec)
    vocab=129_280,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    tie_embeddings=False,
    mla=MLAConfig(n_heads=128, q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff=2048, n_shared=1,
                  capacity_factor=1.25, router="sigmoid", routed_scale=2.5),
    n_dense_layers=3,
    dense_d_ff=18432,
    mtp=True,
)

SMOKE = LMConfig(
    name="dsv3-smoke",
    n_layers=3,
    d_model=48,
    n_heads=4,
    n_kv_heads=4,
    d_ff=32,
    vocab=256,
    mla=MLAConfig(n_heads=4, q_lora_rank=24, kv_lora_rank=16,
                  qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared=1,
                  router="sigmoid", routed_scale=2.5),
    n_dense_layers=1,
    dense_d_ff=96,
    mtp=True,
    param_dtype="float32",
)

ARCH = ArchSpec(
    arch_id="deepseek-v3-671b",
    family="moe",
    make_model=lambda: DecoderLM(CONFIG),
    make_smoke=lambda: DecoderLM(SMOKE),
    large=True,
    optimizer="adafactor",
    sub_quadratic=False,
    notes="MLA absorbed decode (57x KV shrink); MTP head = extra unit",
)
