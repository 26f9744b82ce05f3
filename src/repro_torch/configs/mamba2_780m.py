"""mamba2-780m — Mamba-2 780M (attention-free SSM, SSD).

[arXiv:2405.21060]: 48 layers, d_model 1536 (d_inner 3072, 48 heads x
head_dim 64), ssm_state 128, vocab 50280, conv width 4.  Same values as
``repro.configs.mamba2_780m``.
"""

from ..models.mamba2 import Mamba2Config, Mamba2LM
from .common import ArchSpec

CONFIG = Mamba2Config(
    name="mamba2-780m",
    n_layers=48,
    d_model=1536,
    vocab=50_280,
    d_state=128,
    head_dim=64,
    expand=2,
    n_groups=1,
    conv_width=4,
    chunk=128,
    param_dtype="bfloat16",
)

SMOKE = Mamba2Config(
    name="mamba2-smoke",
    n_layers=3,
    d_model=48,
    vocab=384,
    d_state=16,
    head_dim=8,
    chunk=8,
    param_dtype="float32",
)

ARCH = ArchSpec(
    arch_id="mamba2-780m",
    family="ssm",
    make_model=lambda: Mamba2LM(CONFIG),
    make_smoke=lambda: Mamba2LM(SMOKE),
    large=False,
    optimizer="adamw",
    sub_quadratic=True,
    notes="attention-free; served on the contiguous backend",
)
