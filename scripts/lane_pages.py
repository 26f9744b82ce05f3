"""Time Whisper's cross-lane read through the paged-attention kernel in
the two layouts it could take, on one GPU.

    python3 scripts/lane_pages.py

8 lanes of 1500 frames, 16/16 heads of width 64, every ``kv_len`` at
1500: the lanes as ``WhisperModel.decode_step`` reads them (contiguous,
seen as pages of 4 through ``WhisperModel.lane_table``) and the same
keys padded to 1504 a lane and read as pages of 16 (a layout the decode
does not take).  Each line gives the held median
(``chip_smoke.median_ms``) and the largest error against the plain
version in float32 (which must stay within ``chip_smoke.TOL``), in
bfloat16 and float32.  Needs one CUDA device; the last line is
``{"ok": true}``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.models.whisper import WhisperModel  # noqa: E402

LANES, FRAMES, HEADS, HD = 8, 1500, 16, 64


def layouts(dtype) -> dict:
    """The same queries and keys in both layouts: name -> the wrapper's
    operands."""
    rng = np.random.default_rng(5)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)) \
            .to("cuda", dtype)

    q = rand(LANES, HEADS, HD)
    k, v = rand(LANES, FRAMES, HEADS, HD), rand(LANES, FRAMES, HEADS, HD)
    kv_len = torch.full((LANES,), FRAMES, dtype=torch.int32, device="cuda")
    model = WhisperModel(cs.whisper_medium.CONFIG)
    ps = model.lane_page(FRAMES)
    out = {f"pages of {ps}": (
        q, k.reshape(-1, ps, HEADS, HD), v.reshape(-1, ps, HEADS, HD),
        model.lane_table(LANES, FRAMES, "cuda"), kv_len)}
    rows = FRAMES + (-FRAMES) % 16
    pad = (0, 0, 0, 0, 0, rows - FRAMES)
    table = torch.arange(LANES * rows // 16, dtype=torch.int32,
                         device="cuda").reshape(LANES, rows // 16)
    out[f"padded to {rows}, pages of 16"] = (
        q, torch.nn.functional.pad(k, pad).reshape(-1, 16, HEADS, HD),
        torch.nn.functional.pad(v, pad).reshape(-1, 16, HEADS, HD),
        table, kv_len)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("lane_pages.py needs a CUDA device")
    smi = cs.nvidia_smi()
    cs._build.build(("paged_attention",))
    for dtype in cs.DTYPES:
        for name, args in layouts(dtype).items():
            got = paged_attention(*args, impl="cuda")
            want = paged_attention(*map(cs._f32, args), impl="ref")
            torch.cuda.synchronize()
            diff = (got.float() - want).abs()
            atol, rtol = cs.TOL[dtype]
            if (diff - atol - rtol * want.abs()).max().item() > 0:
                raise RuntimeError(f"{name} {dtype}: beyond tolerance")
            cs.emit({"layout": name, "dtype": str(dtype),
                     "table": args[3].shape[1],
                     "ms": cs.median_ms(
                         lambda: paged_attention(*args, impl="cuda")),
                     "max_abs_err": diff.max().item()})
    print(smi, flush=True)
    cs.emit({"ok": True})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
