"""llava-next-34b — LLaVA-NeXT 34B backbone (VLM; the anyres vision
tower is a stub).

60 layers, d_model 7168, 56 heads with GQA kv=8 (group 7), d_ff 20480,
vocab 64000 (the Yi-34B trunk), RoPE theta 5e6, untied head.  Requests
bring precomputed patch embeddings ``[n_patches, d_model]`` (576: one
base tile), prepended to the token embeddings; the loss covers the text
tail only.  Same values as ``repro.configs.llava_next_34b``.
"""

from ..models.transformer import DecoderLM, LMConfig
from .common import ArchSpec

CONFIG = LMConfig(
    name="llava-next-34b",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64_000,
    head_dim=128,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=5_000_000.0,
    tie_embeddings=False,
)

SMOKE = LMConfig(
    name="llava-smoke",
    n_layers=3,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=160,
    vocab=512,
    head_dim=8,
    param_dtype="float32",
)

ARCH = ArchSpec(
    arch_id="llava-next-34b",
    family="vlm",
    make_model=lambda: DecoderLM(CONFIG),
    make_smoke=lambda: DecoderLM(SMOKE),
    large=True,
    optimizer="adafactor",
    sub_quadratic=False,
    frontend="vision",
    n_frontend_tokens=576,
    notes="anyres tiling stubbed as precomputed patch embeddings",
)
