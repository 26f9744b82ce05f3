"""whisper-medium — Whisper medium backbone (encoder-decoder; the conv
frontend is a stub).

[arXiv:2212.04356]: 24 encoder + 24 decoder layers, d_model 1024, 16
heads (MHA), d_ff 4096 (GELU), vocab 51865, 1500 audio frames.  Requests
bring precomputed frame embeddings ``[n_frames, d_model]`` (the output
of Whisper's two conv layers).  ``max_positions`` is the reference's
32k stress value; the published decoder stops at 448.  Same values as
``repro.configs.whisper_medium``.
"""

from ..models.whisper import WhisperConfig, WhisperModel
from .common import ArchSpec

CONFIG = WhisperConfig(
    name="whisper-medium",
    n_enc_layers=24,
    n_dec_layers=24,
    d_model=1024,
    n_heads=16,
    d_ff=4096,
    vocab=51_865,
    n_frames=1500,
    max_positions=32_776,
)

SMOKE = WhisperConfig(
    name="whisper-smoke",
    n_enc_layers=2,
    n_dec_layers=2,
    d_model=32,
    n_heads=4,
    d_ff=64,
    vocab=256,
    n_frames=12,
    max_positions=64,
    param_dtype="float32",
)

ARCH = ArchSpec(
    arch_id="whisper-medium",
    family="audio",
    make_model=lambda: WhisperModel(CONFIG),
    make_smoke=lambda: WhisperModel(SMOKE),
    large=False,
    optimizer="adamw",
    sub_quadratic=False,
    frontend="audio",
    n_frontend_tokens=1500,
    notes="enc-dec; cross-attention decode against cached encoder KV; "
          "served on the contiguous backend",
)
