"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, serve.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and the exit
code is non-zero):

1. ``device``  — the card (``nvidia-smi`` name and power limit), torch
   and CUDA versions.  No CUDA device: raise.
2. ``build``   — compile every kernel of ``src/repro_torch/kernels/csrc``
   with ``nvcc`` (one process per source, in parallel).
3. ``kernel``  — each kernel against its plain PyTorch version on the
   card at the serving slice's full-width shapes (the serve phase's own
   geometry first, then deeper, wider and windowed cases), in bfloat16
   and float32, held to ``atol + rtol * |plain in float32|``; median
   CUDA-event times of the kernel, the plain version and, where one
   exists, a library call; the least time the card could take (bound).
4. ``reference`` — granite-3-2b SMOKE (float32) served by the paged
   engine on the card (through both kernels) must emit exactly the
   greedy tokens of the plain naive loop on the CPU, same weights.
5. ``serve``   — granite-3-2b at full width and depth (40 layers, random
   bfloat16 weights from a seeded generator) serves 12 greedy requests
   (prompts of 64-512 tokens, 32 new tokens each, one with an EOS)
   through ``ServeEngine(kv_backend="paged")``.  Launch counters are set
   to 0 just before and read just after: both kernels must have run.
6. ``profile`` — decode ticks alone under ``torch.profiler``: device
   time per tick by kernel class, to set beside the serve phase's
   unprofiled ms per tick.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import granite_3_2b  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.models.layers import count_params  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serve import (EngineConfig, NaiveLoop, Request,  # noqa: E402
                               ServeEngine)

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 3.35 TB/s,
# bf16 tensor cores 989 TFLOP/s, float32 outside the tensor cores 67.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# |kernel - plain in float32 on the same values| <= atol + rtol * |plain|.
# float32: summation order only.  bfloat16: the kernel's output rounding
# (2^-8 relative) with 4x room, plus an absolute floor for outputs near 0.
TOL = {torch.bfloat16: (2e-3, 1.6e-2), torch.float32: (2e-5, 0.0)}
DTYPES = (torch.bfloat16, torch.float32)            # bf16 is the main path's

# Each kernel's cases; the first is at the serve phase's own geometry and
# gives the kernels line its numbers.  The serve phase runs max_seq 544
# (34 pages of 16) and admission groups of b <= 2, prompts up to 512.
KERNELS = {
    "paged_attention": {
        "fn": paged_attention,
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:150",
        "cases": [{"mb": 34, "max_len": 544},
                  {"mb": 64, "max_len": 1024},
                  {"mb": 34, "max_len": 544, "window": 128}],
    },
    "flash_attention": {
        "fn": flash_attention,
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:103",
        "cases": [{"b": 2, "s": 256}, {"b": 1, "s": 512},
                  {"b": 4, "s": 512}, {"b": 2, "s": 512, "window": 128}],
    },
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing

def median_ms(fn, *, reps: int = 30, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times; L2 is flushed before each
    call (the serving path finds a layer's KV cold)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- kernels

def paged_case(dtype, *, mb, max_len, window=None, seed=0):
    """Decode at granite-3-2b width: 8 slots, 32/8 heads, head_dim 64,
    16-token pages, ``mb`` blocks per slot, ragged kv_len up to
    ``max_len`` (one slot at one page, one at ``max_len``)."""
    slots, n_q, n_kv, hd, ps = 8, 32, 8, 64, 16
    rng = np.random.default_rng(seed)
    n_pages = 1 + slots * mb
    kv_len = rng.integers(1, max_len + 1, size=slots)
    kv_len[0], kv_len[-1] = ps, max_len
    bt = rng.permutation(np.arange(1, n_pages)).reshape(slots, mb)
    for s in range(slots):
        bt[s, -(-int(kv_len[s]) // ps):] = 0
    dev = "cuda"

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)) \
            .to(dev, dtype)

    args = (rand(slots, n_q, hd), rand(n_pages, ps, n_kv, hd),
            rand(n_pages, ps, n_kv, hd),
            torch.tensor(bt, dtype=torch.int32, device=dev),
            torch.tensor(kv_len, dtype=torch.int32, device=dev))
    es = torch.tensor([], dtype=dtype).element_size()
    # the keys this data needs: each slot's last min(kv_len, window)
    tokens = int(np.minimum(kv_len, window or max_len).sum())
    nbytes = (2 * slots * n_q * hd * es          # q in, out
              + 2 * tokens * n_kv * hd * es      # the K and V these need
              + bt.size * 4 + slots * 4)
    flops = 4.0 * n_q * hd * tokens              # QK^T and PV
    shape = (f"slots {slots}, 32/8 heads, hd 64, page 16, max_blocks {mb}, "
             f"kv_len <= {max_len}" + (f", window {window}" if window else ""))
    return args, {"window": window}, nbytes, flops, None, shape


def flash_case(dtype, *, b, s, window=None, seed=1):
    """Prefill at granite-3-2b width: 32/8 heads, head_dim 64, causal,
    optionally with a local window."""
    n_q, n_kv, hd = 32, 8, 64
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)) \
            .to("cuda", dtype)

    q, k, v = rand(b, s, n_q, hd), rand(b, s, n_kv, hd), rand(b, s, n_kv, hd)
    es = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * es
    rows = np.arange(1, s + 1)                         # keys row r sees
    pairs = int(np.minimum(rows, window or s).sum())
    flops = 4.0 * b * n_q * hd * pairs
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = None
    if window:
        pos = torch.arange(s, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) \
            & (pos[None, :] > pos[:, None] - window)

    def library():
        # yardstick only: the port never calls it
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None,
            enable_gqa=True)

    shape = (f"b {b}, s {s}, 32/8 heads, hd 64, causal"
             + (f", window {window}" if window else ""))
    return (q, k, v), {"causal": True, "window": window}, nbytes, flops, \
        library, shape


CASES = {"paged_attention": paged_case, "flash_attention": flash_case}


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.is_floating_point() else t


def check_kernel(name: str) -> dict:
    """Every case in both dtypes: the kernel against its plain version in
    float32 on the same input values, then the times and the bound."""
    fn = KERNELS[name]["fn"]
    checks = []
    for geometry in KERNELS[name]["cases"]:
        for dtype in DTYPES:
            args, kw, nbytes, flops, library, shape = \
                CASES[name](dtype, **geometry)
            got = fn(*args, **kw, impl="cuda")
            want = fn(*args, **kw, impl="ref")
            want32 = fn(*map(_f32, args), **kw, impl="ref")
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != want.shape \
                    or not torch.isfinite(got.float()).all():
                raise RuntimeError(f"{name} {shape} {dtype}: output "
                                   f"{got.dtype} {tuple(got.shape)} or "
                                   "non-finite")
            atol, rtol = TOL[dtype]
            diff = (got.float() - want32).abs()
            excess = (diff - atol - rtol * want32.abs()).max().item()
            err = diff.max().item()
            if excess > 0:
                raise RuntimeError(f"{name} {shape} {dtype}: max abs err "
                                   f"{err} beyond atol {atol} + rtol {rtol}")
            b_ms, b_by = bound(nbytes, flops, dtype)
            row = {
                "shape": shape, "dtype": str(dtype).removeprefix("torch."),
                "max_abs_err": err, "atol": atol, "rtol": rtol,
                "max_abs_err_vs_plain_same_dtype":
                    (got.float() - want.float()).abs().max().item(),
                "ms": median_ms(lambda: fn(*args, **kw, impl="cuda")),
                "plain_ms": median_ms(lambda: fn(*args, **kw, impl="ref")),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": median_ms(library) if library else None,
                "bytes": nbytes, "flops": flops,
            }
            emit({"phase": "kernel", "name": name, **row})
            checks.append(row)
    return {"name": name, "route": "cuda", "source": KERNELS[name]["source"],
            "replaces": KERNELS[name]["replaces"], "checks": checks}


# ---------------------------------------------------------------- serving

def reference_check() -> dict:
    """SMOKE (float32) on the card through both kernels == the plain
    naive loop on the CPU, token for token."""
    model = DecoderLM(granite_3_2b.SMOKE)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    cpu_params = _to(params, "cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, model.cfg.vocab, n).tolist()
               for n in (5, 9, 9, 14, 3, 7)]
    budgets = (6, 4, 8, 3, 7, 5)
    eng = ServeEngine(model, params, EngineConfig(
        max_batch=4, max_seq=32, decode_block=4, kv_backend="paged",
        page_size=8), device="cuda")
    f0, p0 = flash_attention.launches, paged_attention.launches
    comps = eng.generate([Request(tokens=p, max_new_tokens=g)
                          for p, g in zip(prompts, budgets, strict=True)])
    if flash_attention.launches == f0 or paged_attention.launches == p0:
        raise RuntimeError("reference run did not go through both kernels")
    loop = NaiveLoop(model, cpu_params, device="cpu")
    for c, p, g in zip(comps, prompts, budgets, strict=True):
        want = loop.generate([p], g)[0].tolist()
        if c.tokens != want:
            raise RuntimeError(f"card {c.tokens} != cpu {want}")
    return {"phase": "reference", "requests": len(comps),
            "tokens": sum(len(c.tokens) for c in comps), "match": True}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def serve_requests(vocab: int, eos_req: int | None = None,
                   eos_id: int | None = None) -> list[Request]:
    rng = np.random.default_rng(3)
    lens = (64, 64, 128, 128, 192, 256, 256, 320, 384, 384, 448, 512)
    return [Request(tokens=rng.integers(0, vocab, n).tolist(),
                    max_new_tokens=32, request_id=i,
                    eos_id=eos_id if i == eos_req else None)
            for i, n in enumerate(lens)]


def serve(model, params, engine_cfg) -> dict:
    cfg = model.cfg
    # warm-up run (first launches, cuBLAS heuristics) whose streams also
    # pick the EOS: request 3 gets the 6th token it emits greedily
    warm = ServeEngine(model, params, engine_cfg, device="cuda")
    base = warm.generate(serve_requests(cfg.vocab))
    eos_req, eos_id = 3, base[3].tokens[5]
    del warm

    engine = ServeEngine(model, params, engine_cfg, device="cuda")
    reqs = serve_requests(cfg.vocab, eos_req, eos_id)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    paged_attention.launches = 0
    t0 = time.perf_counter()
    comps = engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "paged_attention": paged_attention.launches}

    for c in comps:
        if c.finish_reason not in ("stop", "length"):
            raise RuntimeError(f"request {c.request_id}: {c.finish_reason}")
        if not all(0 <= t < cfg.vocab for t in c.tokens):
            raise RuntimeError(f"request {c.request_id}: token out of range")
        if c.request_id != eos_req and (len(c.tokens) != 32
                                        or c.finish_reason != "length"):
            raise RuntimeError(f"request {c.request_id}: {len(c.tokens)} "
                               f"tokens, {c.finish_reason}")
    stop_at = base[eos_req].tokens.index(eos_id) + 1
    eos_comp = comps[eos_req]
    if eos_comp.finish_reason != "stop" \
            or eos_comp.tokens != base[eos_req].tokens[:stop_at]:
        raise RuntimeError(f"EOS request: {eos_comp.finish_reason} "
                           f"{eos_comp.tokens} vs {base[eos_req].tokens}")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel was not launched on the main path: "
                           f"{launches}")

    st = engine.stats
    ticks = st.slot_ticks_total // engine_cfg.slots
    ttft = sorted(st.ttft_s)
    return {
        "phase": "serve", "arch": cfg.name, "layers": cfg.n_layers,
        "d_model": cfg.d_model, "params": count_params(params),
        "dtype": cfg.param_dtype,
        "requests": st.requests_completed,
        "finish": {c.request_id: c.finish_reason for c in comps},
        "prompt_tokens": st.prompt_tokens,
        "generated_tokens": st.generated_tokens,
        "wall_s": wall,
        "prefill_s": st.prefill_time_s,
        "prefill_tokens_per_s": st.prompt_tokens / st.prefill_time_s,
        "decode_s": st.decode_time_s,
        "decode_tokens_per_s": st.decode_tokens_per_s,
        "mean_ttft_ms": st.mean_ttft_s * 1e3,
        "median_ttft_ms": statistics.median(ttft) * 1e3,
        "max_ttft_ms": ttft[-1] * 1e3,
        "decode_ticks": ticks,
        "ms_per_decode_tick": st.decode_time_s * 1e3 / ticks,
        "prefill_batches": st.prefill_batches,
        "admit_ticks": st.admit_ticks,
        "peak_pages_in_use": engine.pool.peak_pages_in_use,
        "peak_kv_bytes": engine.pool.peak_kv_bytes(),
        "pool_bytes": engine.pool.kv_bytes(),
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
    }


def _kernel_class(name: str) -> str:
    low = name.lower()
    for cls in ("paged_attention", "flash_attention"):
        if cls in low:
            return cls
    if any(s in low for s in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "matmul"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    return "other"


def profile_decode(model, params, engine_cfg) -> dict:
    """Decode ticks alone under ``torch.profiler``: 8 requests fill the 8
    slots, the first step (admission and one block) runs unprofiled, and
    every later step is pure decode.  Device time is summed over the
    device-side events (kernels, copies) only, per kernel class."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    engine = ServeEngine(model, params, engine_cfg, device="cuda")
    for r in serve_requests(model.cfg.vocab)[:engine_cfg.slots]:
        engine.submit(r)
    engine.step()
    ticks0 = engine.stats.slot_ticks_total
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        while engine.has_work:
            engine.step()
        torch.cuda.synchronize()
    ticks = (engine.stats.slot_ticks_total - ticks0) // engine_cfg.slots
    ms: dict[str, float] = {}
    count: dict[str, int] = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        cls = _kernel_class(ev.name)
        ms[cls] = ms.get(cls, 0.0) + ev.time_range.elapsed_us() / 1e3
        count[cls] = count.get(cls, 0) + 1
    return {
        "phase": "profile", "window": "decode only", "ticks": ticks,
        "device_ms_per_tick": sum(ms.values()) / ticks,
        "device_ms_per_tick_by_class": {k: v / ticks for k, v in ms.items()},
        "launches_per_tick_by_class": {k: v / ticks
                                       for k, v in count.items()},
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    seconds = _build.build()
    emit({"phase": "build", "seconds": seconds,
          "wall_s": time.perf_counter() - t0,
          "ptxas": {k: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, log in _build.build_logs.items()}})

    kernels = [check_kernel(k) for k in KERNELS]
    emit(reference_check())

    model = DecoderLM(granite_3_2b.CONFIG)      # full width and depth
    params = model.init(torch.Generator("cuda").manual_seed(0))
    if count_params(params) != model.param_count():
        raise RuntimeError("parameter count disagrees with the config")
    engine_cfg = EngineConfig(max_batch=8, max_seq=544, decode_block=8,
                              kv_backend="paged", page_size=16)
    result = serve(model, params, engine_cfg)
    emit(result)
    emit(profile_decode(model, params, engine_cfg))

    rows = []
    for k in kernels:
        main_row = k["checks"][0]      # serve geometry, bfloat16
        rows.append({
            "name": k["name"], "route": k["route"], "source": k["source"],
            "replaces": k["replaces"],
            "launches": result["launches"][k["name"]],
            "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "shape": main_row["shape"], "dtype": main_row["dtype"],
            "checks": k["checks"],
        })
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
