"""recurrentgemma-9b — Griffin hybrid (RG-LRU + local attention, 1:2).

[arXiv:2402.19427]: 38 temporal layers in pattern (rec, rec, attn),
d_model 4096, 16 heads MQA (kv=1, head_dim 256), d_ff 12288 (GeGLU),
lru_width 4096, window 2048, vocab 256000, tied embeddings.  Same values
as ``repro.configs.recurrentgemma_9b``.

Organised as 12 superblocks of (rec, rec, attn) + a 2-layer rec tail; a
superblock is one DreamDDP unit — the heterogeneous-cost case where
Algorithm 2's schedule beats the equal-number partition.
"""

from ..models.rglru import RGConfig, RGLM
from .common import ArchSpec

CONFIG = RGConfig(
    name="recurrentgemma-9b",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256_000,
    lru_width=4096,
    head_dim=256,
    window=2048,
    conv_width=4,
    pattern=("rec", "rec", "attn"),
)

SMOKE = RGConfig(
    name="rg-smoke",
    n_layers=5,
    d_model=32,
    n_heads=4,
    n_kv_heads=1,
    d_ff=64,
    vocab=256,
    lru_width=32,
    head_dim=8,
    window=8,
    param_dtype="float32",
)

ARCH = ArchSpec(
    arch_id="recurrentgemma-9b",
    family="hybrid",
    make_model=lambda: RGLM(CONFIG),
    make_smoke=lambda: RGLM(SMOKE),
    large=False,
    optimizer="adafactor",
    sub_quadratic=True,
    notes="1:2 attn:rec; window attention => constant-size decode state; "
          "served on the contiguous backend",
)
