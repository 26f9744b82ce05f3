"""moonlight-16b-a3b — Moonlight-16B-A3B (MLA without query LoRA, dropless
MoE with 64 routed and 2 shared experts).

Published config (huggingface.co/moonshotai/Moonlight-16B-A3B,
``config.json``, a DeepSeek-V3 block): 27 layers at d_model 2048, the
first dense (d_ff 11264) and 26 MoE; MLA with 16 heads, no query LoRA,
kv_lora 512, qk_nope 128, qk_rope 64, v 128, rope theta 50000; 64 routed
experts of width 1408, top-6 by sigmoid scores (``noaux_tc``, one group),
renormalised and scaled by 2.446, plus 2 shared experts; no MTP; untied
vocabulary of 163,840.  The expert layer is the port's dropless one
(:class:`~repro_torch.models.moe.HeldMoEConfig`) with every expert held;
a share of expert parallelism is ``experts_held`` (the benchmark's cell
holds 8 of 64).
The JAX package has no such architecture, so it has no cell in the
production dry run (:func:`repro_torch.configs.all_cells`).

Departures (random weights, so none changes what the layer computes):
RMSNorm eps is the port's 1e-6 (published 1e-5); rope rotates halves
(published: interleaved pairs, a fixed permutation of the rope columns);
the router leaf is float32 and the ``noaux_tc`` selection bias is left
out (zero until its update, which the port does not run).
"""

from ..models.mla import MLAConfig
from ..models.moe import HeldMoEConfig
from ..models.transformer import DecoderLM, LMConfig
from .common import ArchSpec

CONFIG = LMConfig(
    name="moonlight-16b-a3b",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                     # per-expert hidden
    vocab=163_840,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=50_000.0,
    tie_embeddings=False,
    mla=MLAConfig(n_heads=16, q_lora_rank=None, kv_lora_rank=512,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
                  rope_theta=50_000.0),
    moe=HeldMoEConfig(n_experts=64, top_k=6, d_ff=1408, n_shared=2,
                      router="sigmoid", routed_scale=2.446),
    n_dense_layers=1,
    dense_d_ff=11264,
)

SMOKE = LMConfig(
    name="moonlight-smoke",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=32,
    vocab=256,
    rope_theta=50_000.0,
    mla=MLAConfig(n_heads=4, q_lora_rank=None, kv_lora_rank=16,
                  qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
                  rope_theta=50_000.0),
    moe=HeldMoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared=2,
                      router="sigmoid", routed_scale=2.446),
    n_dense_layers=1,
    dense_d_ff=96,
    param_dtype="float32",
)

ARCH = ArchSpec(
    arch_id="moonlight-16b-a3b",
    family="moe",
    make_model=lambda: DecoderLM(CONFIG),
    make_smoke=lambda: DecoderLM(SMOKE),
    large=True,
    optimizer="adamw",
    sub_quadratic=False,
    notes="MLA without query LoRA; dropless expert layer on the grouped "
          "GEMM kernel, a share of experts held per chip",
)
