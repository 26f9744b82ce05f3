"""Time the paged-attention kernel's C entry at chosen splits, where the
wrapper would pick its own (``split_pages``), on one GPU.

    python3 scripts/paged_splits.py

At ``chip_smoke.py``'s Griffin ring geometry (8 lanes, 16/1 heads, head
width 256, rings of 2048 keys as 16-key pages, the model's table two
rings wide) in bfloat16: every (splits, pages per split) from the
wrapper's choice down to one split; the same call with every ``kv_len``
at 1 (one live page a lane: the launch's fixed cost); one query head
instead of 16 (the per-row work); and at granite's serve geometry (8
slots, 32/8 heads, width 64, 34 blocks).  Each line gives the held
median (``chip_smoke.median_ms``) and the largest error against the
plain version in float32 (which must stay within ``chip_smoke.TOL``).
Needs one CUDA device; the last line is ``{"ok": true}``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels.paged_attention import ops  # noqa: E402


def timed(args, splits: int, pps: int, window: int | None) -> dict:
    """The C entry at ``splits`` x ``pps`` on ``args`` (the wrapper's
    operands): held median ms and max abs error against the plain
    version in float32."""
    q, kp, vp, bt, kv_len = args
    slots, n_q, hd = q.shape
    _, ps, n_kv, _ = kp.shape
    scratch = (None, None, None)
    if splits > 1:
        scratch = ops._new_scratch(q.device, *ops._scratch_sizes(
            slots, n_q, n_kv, hd, splits))
    out = torch.empty_like(q)
    fn = ops._fn(q.dtype)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
                 kv_len.data_ptr(), out.data_ptr(),
                 *(None if t is None else t.data_ptr() for t in scratch),
                 slots, n_q, n_kv, hd, ps, bt.shape[1], splits, pps,
                 -1 if window is None else window, hd ** -0.5, stream)
        if err:
            raise RuntimeError(f"paged_attention launch failed: {err}")

    call()
    want = ops.paged_attention_ref(*map(cs._f32, args), window=window)
    torch.cuda.synchronize()
    diff = (out.float() - want).abs()
    atol, rtol = cs.TOL[q.dtype]
    if (diff - atol - rtol * want.abs()).max().item() > 0:
        raise RuntimeError(f"paged_attention at {splits} x {pps}: beyond "
                           "tolerance")
    return {"splits": splits, "pps": pps, "ms": cs.median_ms(call),
            "max_abs_err": diff.max().item()}


def sweep(what: str, args, window, splits_list) -> None:
    chosen = ops.launch_plan(args[0], args[1], args[3])
    for splits, pps in [chosen, *splits_list]:
        cs.emit({"case": what, "chosen": (splits, pps) == chosen,
                 **timed(args, splits, pps, window)})


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("paged_splits.py needs a CUDA device")
    smi = cs.nvidia_smi()
    cs._build.build(("paged_attention",))
    dtype = torch.bfloat16
    args, kw, *_ = cs.ring_case(dtype)
    window = kw["window"]
    mb = args[3].shape[1]
    sweep("ring 16/1 hd 256", args, window,
          [(-(-mb // p), p) for p in (6, 12, 24, 43, 86, mb)])
    q, kp, vp, bt, kv_len = args
    sweep("ring 16/1 hd 256, kv_len 1", (q, kp, vp, bt,
                                         torch.ones_like(kv_len)),
          window, [(1, mb)])
    sweep("ring 1/1 hd 256", (q[:, :1].contiguous(), kp, vp, bt, kv_len),
          window, [(-(-mb // 24), 24)])
    granite, *_ = cs.paged_case(dtype, mb=34, max_len=544)
    sweep("granite 32/8 hd 64", granite, None, [(6, 6), (1, 34)])
    print(smi, flush=True)
    cs.emit({"ok": True})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
