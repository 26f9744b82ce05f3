"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, serve,
train.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and the exit
code is non-zero):

1. ``device``  — the card (``nvidia-smi`` name and power limit), torch
   and CUDA versions.  No CUDA device: raise.
2. ``build``   — compile every kernel of ``src/repro_torch/kernels/csrc``
   with ``nvcc`` (one process per source, in parallel).
3. ``kernel``  — each kernel against its plain PyTorch version on the
   card at its path's full-width shapes, with median CUDA-event times of
   the kernel, the plain version and, where one exists, a library call
   (device time alone: a sleep kernel holds the stream while the host
   enqueues; a ``timing`` line first gives the floor, one trivial
   kernel's time), and the least time the card could take (bound).
   Attention kernels (the serve phase's own geometry first, then deeper,
   wider, windowed and one-slot cases), in bfloat16 and float32, held to
   ``atol + rtol * |plain in float32|``.  Training kernels at the train phase's
   geometry: fused AdamW on the largest leaf (``blocks.mlp.gate.w``,
   ``[4, 8, 2048, 8192]``) in bfloat16 and float32, held to ``atol +
   rtol * |plain|``; the int8 row kernels on one phase's block slices
   (gate ``[R, 8192]``, down ``[R, 2048]``, wk/wv ``[R, 512]``, a norm
   ``[4k, 2048]``) and the embedding leaf, codes, scales and values
   **equal** to the plain version's, each with its shape's launches in
   the int8 run as the wrapper counts them (checked, shape by shape,
   against a reckoning from the plan).
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
7. ``train_reference`` — granite-3-2b SMOKE (float32), W=2, H=5, 10
   steps of ``Session.fit`` for ``dreamddp`` and ``dreamddp-int8`` on the
   card (through the training kernels) and on the CPU (plain versions)
   from the same initial parameters and batches: per-step losses and
   final parameters within the float32 tolerances of ``TRAIN_REF_TOL``.
8. ``train``   — granite-3-2b at published widths, depth cut 40 -> 8 and
   workers 8 -> 4 (the worker-stacked state has to fit one card),
   bfloat16, ``Session(JobConfig(workers=4, period=5,
   batch_per_worker=4, seq=512, smoke=False))`` for 10 steps with
   ``dreamddp``, then 10 with ``dreamddp-int8`` in a fresh session.
   Launch counters are set to 0 just before each ``fit`` and read just
   after: fused AdamW must run 11 x steps, the int8 kernels in the int8
   run.  Reports ms/step (the second period's time / H), tokens/s,
   MFU, peak memory, first and last loss (finite, falling).
9. ``train_profile`` — one more period of the int8 session under
   ``torch.profiler``: device ms per step by kernel class and the
   device's busy share of the wall time.
10. ``kernel`` (SSD) — the SSD chunk kernel against its plain version,
   first as the Mamba-2 serve phase calls it (``ssd_chunk_grouped`` on
   the model's layout: B 2, Lp 512, 48 heads, 1 group, cs 128, p 64, n
   128; x float32, b and c bfloat16 views of one conv output), then in
   the TPU layout (``ssd_chunk``) at the same cells, at B 1 x NC 8 all
   float32 and at the smoke widths (cs 8, p 8, n 16), held to ``1e-4 *
   max|plain|`` for y and for the states.
11. ``mamba2_reference`` — mamba2 SMOKE (float32) served by the
   contiguous engine on the card (through the SSD kernel) must emit
   exactly the greedy tokens of the plain naive loop on the CPU, same
   weights, and its prefill and decode logits must agree within
   ``MAMBA_REF_TOL``.
12. ``mamba2_serve`` — mamba2-780m at full width and depth (48 layers,
   d_model 1536, random bfloat16 weights from a seeded generator) serves
   12 greedy requests (prompts of 100-1024 tokens, 32 new tokens each,
   one with an EOS) through ``ServeEngine`` on the contiguous backend.
   The grouped SSD entry's counter is set to 0 just before and read
   just after: 48 launches per prefill call.
13. ``mamba2_profile`` — its decode ticks alone under ``torch.profiler``.

Then one ``{"kernels": [...]}`` line (each kernel's cases, launches on
its path, and ptxas's registers, shared memory and spills for its
source), the ``nvidia-smi`` line, and last ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.api import JobConfig, Session  # noqa: E402
from repro_torch.configs import granite_3_2b, mamba2_780m  # noqa: E402
from repro_torch.core.partial_sync import contiguous_ranges  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.fused_adam_sync import fused_adamw  # noqa: E402
from repro_torch.kernels.int8_quant import (dequantize_rows,  # noqa: E402
                                            quantize_rows)
from repro_torch.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.kernels.ssd_scan import (ssd_chunk,  # noqa: E402
                                          ssd_chunk_grouped)
from repro_torch.models.layers import count_params  # noqa: E402
from repro_torch.models.mamba2 import Mamba2LM  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serve import (EngineConfig, NaiveLoop, Request,  # noqa: E402
                               ServeEngine)
from repro_torch.tree import tree_leaves  # noqa: E402

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
                  {"mb": 34, "max_len": 544, "window": 128},
                  {"mb": 64, "max_len": 1024, "slots": 1}],
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

def median_ms(fn, *, reps: int = 30, warmup: int = 3,
              hold: bool = True) -> float:
    """Median of per-call CUDA-event times of the device's work alone; L2
    is flushed before each call (the serving path finds a layer's KV
    cold).  A sleep kernel of ~4x the call's host enqueue time (at 2 GHz)
    holds the stream first, so that the host has queued the flush, the
    events and the call before the device reaches them: no host gap
    lands between the events, however small the kernel.  ``hold=False``
    drops the sleep: a host enqueue slower than the flush then counts
    (the kernel times of ``PERF.md`` before the attention redesign)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    cycles = int(min(8e9 * (time.perf_counter() - t0) + 2e5, 2e7))
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if hold:
            torch.cuda._sleep(cycles)
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, *work: tuple[float, torch.dtype]
          ) -> tuple[float, str]:
    """The larger of the byte time and the operation time; ``work`` is
    (flops, operand dtype) pairs, each at its dtype's peak, times added."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = sum(f / PEAK_FLOPS[dt] for f, dt in work) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- kernels

def paged_case(dtype, *, mb, max_len, window=None, slots=8, seed=0):
    """Decode at granite-3-2b width: ``slots`` slots, 32/8 heads,
    head_dim 64, 16-token pages, ``mb`` blocks per slot, ragged kv_len up
    to ``max_len`` (one slot at one page, the last at ``max_len``)."""
    n_q, n_kv, hd, ps = 32, 8, 64, 16
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
            b_ms, b_by = bound(nbytes, (flops, dtype))
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


SERVE_LENS = (64, 64, 128, 128, 192, 256, 256, 320, 384, 384, 448, 512)


def serve_requests(vocab: int, eos_req: int | None = None,
                   eos_id: int | None = None, *, lens=SERVE_LENS,
                   seed: int = 3) -> list[Request]:
    rng = np.random.default_rng(seed)
    return [Request(tokens=rng.integers(0, vocab, n).tolist(),
                    max_new_tokens=32, request_id=i,
                    eos_id=eos_id if i == eos_req else None)
            for i, n in enumerate(lens)]


def drive_serve(model, params, engine_cfg, make_requests, kernels) -> tuple:
    """A warm-up run, then the timed run of ``make_requests(vocab,
    eos_req, eos_id)`` with the ``kernels``' launch counters set to 0
    just before and read just after; checks every stream.  Returns (the
    phase's common numbers, the engine, launches by kernel name)."""
    cfg = model.cfg
    # warm-up run (first launches, cuBLAS heuristics) whose streams also
    # pick the EOS: request 3 gets the 6th token it emits greedily
    warm = ServeEngine(model, params, engine_cfg, device="cuda")
    base = warm.generate(make_requests(cfg.vocab))
    eos_req, eos_id = 3, base[3].tokens[5]
    del warm

    engine = ServeEngine(model, params, engine_cfg, device="cuda")
    reqs = make_requests(cfg.vocab, eos_req, eos_id)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    comps = engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}

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
    common = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": count_params(params), "dtype": cfg.param_dtype,
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
    }
    return common, engine, launches


def serve(model, params, engine_cfg) -> dict:
    common, engine, launches = drive_serve(
        model, params, engine_cfg, serve_requests,
        {"flash_attention": flash_attention,
         "paged_attention": paged_attention})
    return {
        "phase": "serve", **common,
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


def profile_decode(model, params, engine_cfg, requests=None,
                   phase="profile") -> dict:
    """Decode ticks alone under ``torch.profiler``: 8 requests fill the 8
    slots, the first step (admission and one block) runs unprofiled, and
    every later step is pure decode.  Device time is summed over the
    device-side events (kernels, copies) only, per kernel class."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    engine = ServeEngine(model, params, engine_cfg, device="cuda")
    requests = requests or serve_requests(model.cfg.vocab)
    for r in requests[:engine_cfg.slots]:
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
        "phase": phase, "window": "decode only", "ticks": ticks,
        "device_ms_per_tick": sum(ms.values()) / ticks,
        "device_ms_per_tick_by_class": {k: v / ticks for k, v in ms.items()},
        "launches_per_tick_by_class": {k: v / ticks
                                       for k, v in count.items()},
    }


# ---------------------------------------------------------------- training

# The train phase's job: granite-3-2b at published widths, depth 40 -> 8
# and workers 8 -> 4 so the worker-stacked state fits one card.
TRAIN_LAYERS, TRAIN_WORKERS, TRAIN_H, TRAIN_B, TRAIN_S = 8, 4, 5, 4, 512
TRAIN_STEPS = 10
TRAIN_MODEL = dataclasses.replace(granite_3_2b.CONFIG, n_layers=TRAIN_LAYERS)
ADAM_FLOPS_PER_ELEMENT = 15        # mul/add/div/sqrt of one AdamW update
# fused AdamW against its plain version: the same correctly rounded
# float32 operations, so only powf in the bias corrections may differ in
# the last place; bfloat16 p may then round to the neighbouring value
# (one bfloat16 ulp, 2^-8 relative).
ADAM_TOL = {torch.float32: (1e-7, 1e-6), torch.bfloat16: (1e-7, 7.9e-3)}
# train_reference, card against CPU after 10 steps of float32 smoke
# training.  Losses: summation order of the float32 matmuls (cuBLAS
# against the CPU's).  Parameters: 99.9% within bulk_atol; the rest
# within max_atol, since Adam turns the rounding noise of a near-zero
# gradient into a step of up to lr (3e-3 at most here); with int8 syncs
# 99% within bulk_atol and the rest within one code's quantum of their
# leaf's scale (max|p| / 127) plus max_atol, since a value near a rounding
# boundary may take the next code.
TRAIN_REF_TOL = {
    "dreamddp": {"loss_rtol": 1e-4, "bulk_atol": 1e-4, "share": 1e-3,
                 "max_atol": 3e-3, "quantum": False},
    "dreamddp-int8": {"loss_rtol": 1e-3, "bulk_atol": 1e-4, "share": 1e-2,
                      "max_atol": 3e-3, "quantum": True},
}


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def train_job(algo: str) -> JobConfig:
    return JobConfig(arch="granite-3-2b", algo=algo, workers=TRAIN_WORKERS,
                     period=TRAIN_H, batch_per_worker=TRAIN_B, seq=TRAIN_S,
                     smoke=False)


def int8_plan() -> tuple[int, str, dict]:
    """The train phase's ``dreamddp-int8`` plan, read for the int8 kernel
    checks: the layers in the longest contiguous block range that one
    phase syncs, that phase and range, and ``quantize_rows`` launches by
    ``(rows, cols)`` in the int8 run's TRAIN_STEPS steps, reckoned as the
    sync cuts the worker-stacked leaves (``tree_unit_map``: a plain
    group's whole leaves, each contiguous block range's ``[:, lo:hi]``
    slices; each one row matrix over its last dimension).  The leaf
    shapes come from fake tensors: no weights are made."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    model = DecoderLM(TRAIN_MODEL)
    plan = Session(train_job("dreamddp-int8"), model=model,
                   device="cuda").plan
    layout = model.unit_layout()
    with FakeTensorMode():
        params = model.init(torch.Generator().manual_seed(0))
        shapes = {group: [(TRAIN_WORKERS, *x.shape)
                          for x in tree_leaves(tree)]
                  for group, tree in params.items()}
    best, launches = (0, ""), collections.Counter()
    for step in range(TRAIN_STEPS):
        h = plan.phase_of_iteration(step)
        for group, idxs in layout.by_group(plan.phase_units[h]).items():
            ranges = [None] if idxs == [None] else contiguous_ranges(idxs)
            for cut in ranges:
                if cut and cut[1] - cut[0] > best[0]:
                    best = (cut[1] - cut[0],
                            f"phase {h}, layers {cut[0]}..{cut[1] - 1}")
                for shape in shapes[group]:
                    dims = list(shape)
                    if cut:
                        dims[1] = cut[1] - cut[0]
                    launches[(math.prod(dims[:-1]), dims[-1])] += 1
    if not best[0]:
        raise RuntimeError("the int8 plan syncs no block layer")
    return best[0], best[1], dict(launches)


def int8_cases(k: int, where: str) -> list[tuple[int, int, str]]:
    """(rows, cols, what) the int8 sync hands ``quantize_rows`` in the
    phase that syncs k contiguous layers: the gate slice first (the
    kernels line's row), then down, the embedding leaf, the wk / wv slice
    and a norm slice."""
    cfg, w = TRAIN_MODEL, TRAIN_WORKERS
    d, f, kv = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.hd
    return [(w * k * d, f, f"gate.w slice ({where})"),
            (w * k * f, d, f"down.w slice ({where})"),
            (w * cfg.vocab, d, "embed.table"),
            (w * k * d, kv, f"wk.w / wv.w slice ({where})"),
            (w * k, d, f"ln1.scale / ln2.scale slice ({where})")]


def adam_case(dtype, shape):
    """The largest leaf of the train phase, worker-stacked."""
    gen = torch.Generator("cuda").manual_seed(7)
    n = math.prod(shape)

    def rand(scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda").mul_(scale)

    p = rand().to(dtype)
    g, m = rand(), rand(0.1)
    v = rand().abs_().mul_(0.01)
    hyper = torch.tensor([3e-3, 0.9, 0.999, 1e-8, 0.0, 6.0], device="cuda")
    nbytes = n * (2 * p.element_size() + 5 * 4)  # p, m, v in+out; g in
    return (p, g, m, v, hyper), nbytes, ADAM_FLOPS_PER_ELEMENT * n


def fused_adam_library(a: list, hyper: torch.Tensor):
    """Time of ``torch._fused_adam_`` (adam with weight decay 0, the same
    function) on the same tensors, as a yardstick the port never calls.
    It is asked to take the kernel's dtypes as they are; where it refuses
    (bfloat16 p with float32 g, m, v) its message is the reason there is
    no time."""
    step = hyper[5].clone()
    lr, b1, b2, eps, wd = (float(x) for x in hyper[:5])

    def call():
        torch._fused_adam_([a[0]], [a[1]], [a[2]], [a[3]], [], [step],
                           lr=lr, beta1=b1, beta2=b2, weight_decay=wd,
                           eps=eps, amsgrad=False, maximize=False)

    try:
        call()
        torch.cuda.synchronize()
    except RuntimeError as e:          # the op's dtype check, not a fault
        return None, f"none: torch._fused_adam_ refused these dtypes ({e})"
    return median_ms(call), "torch._fused_adam_ (adam, weight_decay 0)"


def check_adam() -> dict:
    """fused AdamW against its plain version on the largest leaf, bfloat16
    (the train phase's) then float32; torch._fused_adam_ as a yardstick
    where it takes the dtypes."""
    shape = (TRAIN_WORKERS, TRAIN_LAYERS, TRAIN_MODEL.d_model,
             TRAIN_MODEL.d_ff)
    checks = []
    for dtype in DTYPES:
        args, nbytes, flops = adam_case(dtype, shape)
        a = [t.clone() for t in args[:4]]
        b = [t.clone() for t in args[:4]]
        fused_adamw(*a, args[4], impl="cuda")
        fused_adamw(*b, args[4], impl="ref")
        torch.cuda.synchronize()
        err, excess = 0.0, -1.0
        for x, y in zip(a, b, strict=True):
            atol, rtol = ADAM_TOL[x.dtype]
            if not torch.isfinite(x.float()).all():
                raise RuntimeError(f"fused_adamw {dtype}: non-finite output")
            d = (x.float() - y.float()).abs()
            err = max(err, d.max().item())
            excess = max(excess,
                         (d - atol - rtol * y.float().abs()).max().item())
        if excess > 0:
            raise RuntimeError(f"fused_adamw {dtype}: max abs err {err} "
                               f"beyond its tolerance")
        del b
        _free()
        ms = median_ms(lambda: fused_adamw(*a, args[4], impl="cuda"))
        plain = [t.clone() for t in args[:4]]
        plain_ms = median_ms(lambda: fused_adamw(*plain, args[4],
                                                 impl="ref"), reps=10)
        del plain
        _free()
        library, reason = fused_adam_library(a, args[4])
        b_ms, b_by = bound(nbytes, (flops, torch.float32))
        row = {"shape": f"{list(shape)} (blocks.mlp.gate.w), "
                        f"{math.prod(shape)} elements",
               "dtype": str(dtype).removeprefix("torch."),
               "max_abs_err": err, "atol_rtol": ADAM_TOL[dtype],
               "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": library,
               "library": reason, "bytes": nbytes, "flops": flops}
        emit({"phase": "kernel", "name": "fused_adamw", **row})
        checks.append(row)
        del a, args
        _free()
    return {"name": "fused_adamw", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_adam_sync.cu",
            "replaces": "src/repro/kernels/fused_adam_sync/kernel.py:60",
            "checks": checks}


def check_int8(k: int, where: str) -> list[dict]:
    """quantize_rows / dequantize_rows against their plain versions on the
    rows the int8 sync hands them (``int8_cases``); codes, scales and
    values must be equal."""
    rows = {"quantize_rows": [], "dequantize_rows": []}
    gen = torch.Generator("cuda").manual_seed(8)
    for r, c, what in int8_cases(k, where):
        x = torch.randn(r, c, generator=gen, device="cuda").mul_(0.02)
        x[0] = 0.0                                   # a zero row
        q, s = quantize_rows(x, impl="cuda")
        qr, sr = quantize_rows(x, impl="ref")
        out = dequantize_rows(q, s, impl="cuda")
        out_r = dequantize_rows(qr, sr, impl="ref")
        torch.cuda.synchronize()
        if not (torch.equal(q, qr) and torch.equal(s, sr)
                and torch.equal(out, out_r)):
            raise RuntimeError(
                f"int8 {what} [{r}, {c}]: codes {(q != qr).sum().item()}, "
                f"scales {(s != sr).sum().item()}, values "
                f"{(out != out_r).sum().item()} differ from the plain "
                "version")
        n = r * c
        shape = f"[{r}, {c}] {what}"
        # yardstick only, the port never calls it: one promoting multiply
        # computes float(q) * s, bit for bit the kernel's function
        torch_mul = (lambda: torch.mul(q, s))
        if not torch.equal(torch_mul(), out):
            raise RuntimeError(f"int8 {what}: torch.mul(q, s) differs from "
                               "the dequantize kernel")
        for name, fn, ref, library, reason, nbytes, flops in (
                ("quantize_rows", lambda: quantize_rows(x, impl="cuda"),
                 lambda: quantize_rows(x, impl="ref"), None,
                 "none: no single PyTorch call", n * 5 + r * 4, 5 * n),
                ("dequantize_rows",
                 lambda: dequantize_rows(q, s, impl="cuda"),
                 lambda: dequantize_rows(q, s, impl="ref"), torch_mul,
                 "torch.mul(q, scale)", n * 5 + r * 4, n)):
            b_ms, b_by = bound(nbytes, (flops, torch.float32))
            row = {"shape": shape, "dtype": "float32 -> int8" if
                   name == "quantize_rows" else "int8 -> float32",
                   "matrix": [r, c],
                   "max_abs_err": 0.0, "ms": median_ms(fn),
                   "plain_ms": median_ms(ref, reps=10), "bound_ms": b_ms,
                   "bound_by": b_by,
                   "library_ms": median_ms(library) if library else None,
                   "library": reason, "bytes": nbytes, "flops": flops}
            emit({"phase": "kernel", "name": name, **row})
            rows[name].append(row)
        del x, q, s, qr, sr, out, out_r
        _free()
    return [{"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/int8_quant.cu",
             "replaces": f"src/repro/kernels/int8_quant/kernel.py:{line}",
             "checks": rows[name]}
            for name, line in (("quantize_rows", 42),
                               ("dequantize_rows", 63))]


def int8_launches(kernels: list[dict], reckoned: dict,
                  measured: list[dict]) -> None:
    """Puts the int8 run's ``quantize_rows`` launches by shape, as the
    wrapper counted them (``measured``), on its kernels-line entry and on
    each of its check rows, after holding them, shape by shape, to
    ``int8_plan``'s reckoning."""
    counted = {tuple(e["shape"]): e["launches"] for e in measured}
    if counted != reckoned:
        raise RuntimeError(f"quantize_rows launched {counted} by shape in "
                           f"the int8 run; the plan reckons {reckoned}")
    for k in kernels:
        if k["name"] == "quantize_rows":
            k["launches_by_shape"] = measured
            for row in k["checks"]:
                row["launches_of_shape"] = counted.get(tuple(row["matrix"]),
                                                       0)


def _reset_train_counts() -> None:
    fused_adamw.launches = 0
    quantize_rows.launches = 0
    quantize_rows.launches_by_shape.clear()
    dequantize_rows.launches = 0


def _train_counts() -> dict:
    return {"fused_adamw": fused_adamw.launches,
            "quantize_rows": quantize_rows.launches,
            "dequantize_rows": dequantize_rows.launches}


def train_reference() -> dict:
    """SMOKE (float32), W=2, H=5: 10 steps of Session.fit on the card
    (through the kernels) against the same on the CPU (plain versions),
    same initial parameters and batches."""
    out = {"phase": "train_reference"}
    for algo, tol in TRAIN_REF_TOL.items():
        job = JobConfig(algo=algo, workers=2, period=5)
        card = Session(job, device="cuda")
        cpu = Session(job, device="cpu")
        for x, y in zip(tree_leaves(cpu.state.params),
                        tree_leaves(card.state.params), strict=True):
            x.copy_(y.cpu())
        _reset_train_counts()
        card.fit(10)
        counts = _train_counts()
        cpu.fit(10)
        if counts["fused_adamw"] != 11 * 10 or (
                algo == "dreamddp-int8") != (counts["quantize_rows"] > 0):
            raise RuntimeError(f"train_reference {algo}: launches {counts}")
        lc = np.array([h["loss"] for h in card.history])
        lp = np.array([h["loss"] for h in cpu.history])
        loss_err = float(np.max(np.abs(lc - lp) / np.abs(lp)))
        if not np.isfinite(lc).all() or loss_err > tol["loss_rtol"]:
            raise RuntimeError(f"train_reference {algo}: losses {lc} vs "
                               f"{lp}")
        worst, share = 0.0, 0.0
        for x, y in zip(tree_leaves(card.state.params),
                        tree_leaves(cpu.state.params), strict=True):
            d = (x.cpu() - y).abs()
            limit = tol["max_atol"] + (y.abs().max().item() / 127
                                       if tol["quantum"] else 0.0)
            frac = (d > tol["bulk_atol"]).float().mean().item()
            if d.max().item() > limit or frac > tol["share"]:
                raise RuntimeError(
                    f"train_reference {algo}: params differ by up to "
                    f"{d.max().item()} (limit {limit}), {frac} beyond "
                    f"{tol['bulk_atol']}")
            worst, share = max(worst, d.max().item()), max(share, frac)
        out[algo] = {"steps": 10, "losses_card": lc.tolist(),
                     "max_loss_rel_err": loss_err,
                     "max_param_abs_err": worst,
                     "max_share_beyond_bulk_atol": share,
                     "launches": counts, "tolerance": tol}
        del card, cpu
        _free()
    return out


def train_flops_per_step(model: DecoderLM) -> float:
    """6 N per token (forward and backward of every parameter) plus the
    attention products (QK and PV over the causal-unmasked full length,
    forward and backward), for one step of every worker; remat's
    recomputation is not counted."""
    cfg = model.cfg
    tokens = TRAIN_WORKERS * TRAIN_B * TRAIN_S
    attn = 3 * 2.0 * tokens * TRAIN_S * cfg.n_heads * cfg.hd * 2 \
        * cfg.n_layers
    return 6.0 * model.param_count() * tokens + attn


def train(algo: str, *, keep: bool = False):
    """One fresh full-width session, TRAIN_STEPS steps, counts around the
    fit."""
    model = DecoderLM(TRAIN_MODEL)
    torch.cuda.reset_peak_memory_stats()
    sess = Session(train_job(algo), model=model, device="cuda")
    plan = sess.plan
    sess.state                                       # build the state
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated()
    _reset_train_counts()
    t0 = time.perf_counter()
    sess.fit(TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _train_counts()
    by_shape = [{"shape": list(shape), "launches": n} for shape, n in
                quantize_rows.launches_by_shape.most_common()]
    losses = [h["loss"] for h in sess.history]
    second = [h["time"] for h in sess.history[TRAIN_H:2 * TRAIN_H]]
    ms = statistics.median(second) * 1e3
    tokens = TRAIN_WORKERS * TRAIN_B * TRAIN_S
    flops = train_flops_per_step(model)
    if counts["fused_adamw"] != 11 * TRAIN_STEPS:
        raise RuntimeError(f"train {algo}: fused_adamw launched "
                           f"{counts['fused_adamw']} times, want "
                           f"{11 * TRAIN_STEPS}")
    if (algo == "dreamddp-int8") != (counts["quantize_rows"] > 0
                                     and counts["dequantize_rows"] > 0):
        raise RuntimeError(f"train {algo}: int8 launches {counts}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise RuntimeError(f"train {algo}: losses {losses}")
    result = {
        "phase": "train", "algo": algo, "arch": TRAIN_MODEL.name,
        "layers": TRAIN_LAYERS, "d_model": TRAIN_MODEL.d_model,
        "reduced": {"n_layers": "40 -> 8", "workers": "8 -> 4"},
        "dtype": TRAIN_MODEL.param_dtype, "workers": TRAIN_WORKERS,
        "H": TRAIN_H, "batch_per_worker": TRAIN_B, "seq": TRAIN_S,
        "params_per_replica": model.param_count(),
        "plan": {"phase_units": [list(u) for u in plan.phase_units],
                 "units_per_phase": [len(u) for u in plan.phase_units],
                 "fingerprint": plan.fingerprint()},
        "steps": TRAIN_STEPS, "wall_s": wall,
        # the fused runner stamps every step of a period with the
        # period's time / H, so each figure is one period's mean
        "ms_per_step": ms, "ms_per_step_first_period":
            statistics.median(h["time"] for h in sess.history[:TRAIN_H])
            * 1e3,
        "ms_per_step_both_periods":
            statistics.fmean(h["time"] for h in sess.history) * 1e3,
        "tokens_per_s": tokens / (ms / 1e3),
        "flops_per_step": flops,
        "mfu": flops / (ms / 1e3) / PEAK_FLOPS[torch.bfloat16],
        "state_bytes": state_bytes,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "first_loss": losses[0], "last_loss": losses[-1],
        "losses": losses, "launches": counts,
        "quantize_rows_launches_by_shape": by_shape,
    }
    if keep:
        return result, sess
    del sess
    _free()
    return result, None


def _train_class(name: str) -> str:
    low = name.lower()
    if "fused_adamw" in low:
        return "optimizer kernel"
    if "quantize_rows" in low:
        return "int8 kernels"
    if any(s in low for s in ("gemm", "gemv", "nvjet", "xmma", "cutlass",
                              "cublas")):
        return "matmuls (attention products included)"
    if "softmax" in low:
        return "attention softmax"
    if "memcpy" in low or "memset" in low or "copy" in low:
        return "copies and casts"
    if "reduce" in low:
        return "reductions (sync means, norms, loss)"
    return "other elementwise"


def train_profile(sess, unprofiled_ms: float) -> dict:
    """One more period of ``sess`` under torch.profiler: device ms per
    step by kernel class; device ms in the step's optimizer and sync
    ranges (``repro_torch.optimizer``, ``repro_torch.sync``: kernels
    launched inside them; the forward and backward are the rest); the
    share of the profiled wall time in which some kernel or copy ran
    (merged intervals); and device ms over the unprofiled step time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.fit(TRAIN_H)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ms: dict[str, float] = {}
    count: dict[str, int] = {}
    spans = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        cls = _train_class(ev.name)
        ms[cls] = ms.get(cls, 0.0) + ev.time_range.elapsed_us() / 1e3
        count[cls] = count.get(cls, 0) + 1
        spans.append((ev.time_range.start, ev.time_range.end))
    spans.sort()
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    ranges = {}
    for ev in prof.key_averages():
        if ev.key in ("repro_torch.optimizer", "repro_torch.sync"):
            total = getattr(ev, "device_time_total", None)
            if total is None:
                total = ev.cuda_time_total
            ranges[ev.key] = total / 1e3 / TRAIN_H
    device_ms = sum(ms.values()) / TRAIN_H
    ranges["forward and backward (the rest)"] = device_ms - sum(
        ranges.values())
    return {
        "phase": "train_profile", "algo": sess.cfg.algo, "steps": TRAIN_H,
        "wall_ms_per_step": wall * 1e3 / TRAIN_H,
        "device_ms_per_step": device_ms,
        "device_ms_per_step_by_class": {k: v / TRAIN_H
                                        for k, v in ms.items()},
        "launches_per_step_by_class": {k: v / TRAIN_H
                                       for k, v in count.items()},
        "device_ms_per_step_by_range": ranges,
        "busy_share": busy / 1e3 / (wall * 1e3),
        "unprofiled_ms_per_step": unprofiled_ms,
        "device_ms_over_unprofiled_step": device_ms / unprofiled_ms,
    }


# ---------------------------------------------------------------- Mamba-2

# |kernel - plain| <= SSD_TOL * max|plain|, for y and for the states.  Both
# compute in float32, but torch.cumsum on the card sums in another order
# than the kernel's sequential scan, and exp(cum_i - cum_j) turns an ulp
# of cum (|cum| reaches ~1400 with the model's decays) into a relative
# error of a score: ~2.5e-5 of max|y| between two orders on the CPU.
SSD_TOL = 1e-4
# mamba2_reference, card against CPU on float32 smoke logits: float32
# sums in another order (cuBLAS without TF32 against the CPU's).
MAMBA_REF_TOL = (1e-4, 1e-4)                       # atol, rtol
# The serve phase: 8 slots, lanes of 1152, prompts of 100-1024 tokens
# (most not a multiple of the chunk, so dt = 0 padding runs; two pairs of
# equal lengths share an admission group); 480 + 480 is the B 2 x NC 4
# prefill the kernel's first case times.
MAMBA_LENS = (100, 100, 250, 333, 480, 480, 512, 640, 777, 900, 1000, 1024)
MAMBA_ENGINE = EngineConfig(max_batch=8, max_seq=1152, decode_block=8)


def _ssd_work(cells, groups_cells, cs, p, n, bc_dtype):
    """(flops, dtype) pairs over the lower triangle: c.b once per group
    cell on b/c's type (exact on bfloat16 tensor cores, whose products
    accumulate in float32); in float32 the exp and the mask product, the
    y product, the decay scaling, its exp and the state product."""
    tri = cs * (cs + 1) // 2
    return [(groups_cells * tri * 2 * n, bc_dtype),
            (cells * (tri * (2 + 2 * p) + cs * (n + 1) + 2 * cs * p * n),
             torch.float32)]


def ssd_grouped_case(*, B, L, H, G, cs, p, n, bc_dtype, seed=5):
    """The serve phase's call: x * dt [B, L, H, p] float32 contiguous, b
    and c [B, L, G, n] as views of one conv output (the model's
    layout), da [B, L, H] with the model's decays: -softplus(z) * A, A =
    1..16 over the heads (a_log's init, dt_bias 0)."""
    gen = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn(B, L, H, p, generator=gen, device="cuda")
    conv = torch.randn(B, L, H * p + 2 * G * n, generator=gen,
                       device="cuda").to(bc_dtype)
    b = conv[..., H * p:H * p + G * n].reshape(B, L, G, n)
    c = conv[..., H * p + G * n:].reshape(B, L, G, n)
    da = (-torch.nn.functional.softplus(
        torch.randn(B, L, H, generator=gen, device="cuda"))
        * torch.linspace(1.0, 16.0, H, device="cuda"))
    nc = L // cs
    es = b.element_size()
    # each input read once (b and c: their own elements, not the view's
    # row), each output written once
    nbytes = x.numel() * 4 + 2 * B * L * G * n * es + da.numel() * 4 \
        + x.numel() * 4 + B * nc * H * p * n * 4
    work = _ssd_work(B * nc * H, B * nc * G, cs, p, n, bc_dtype)
    shape = (f"grouped (serve call): B {B}, Lp {L}, H {H}, G {G}, cs {cs}, "
             f"p {p}, n {n}, x float32, b/c "
             f"{str(bc_dtype).removeprefix('torch.')} views of the conv "
             "output")
    return ssd_chunk_grouped, (x, b, c, da, cs), nbytes, work, shape


def ssd_case(*, B, NC, H, cs, p, n, bc_dtype, seed=5):
    """The TPU layout [B, NC, H, cs, .], one group per head."""
    gen = torch.Generator("cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = rand(B, NC, H, cs, p)
    b, c = rand(B, NC, H, cs, n).to(bc_dtype), rand(B, NC, H, cs, n).to(
        bc_dtype)
    da = (-torch.nn.functional.softplus(rand(B, NC, H, cs))
          * torch.linspace(1.0, 16.0, H, device="cuda")[:, None])
    cells = B * NC * H
    nbytes = sum(t.numel() * t.element_size() for t in (x, b, c, da)) \
        + x.numel() * 4 + cells * p * n * 4          # y, states out
    work = _ssd_work(cells, cells, cs, p, n, bc_dtype)
    shape = (f"TPU layout: B {B}, NC {NC}, H {H}, cs {cs}, p {p}, n {n}, "
             f"x float32, b/c {str(bc_dtype).removeprefix('torch.')}")
    return ssd_chunk, (x, b, c, da), nbytes, work, shape


def ssd_cases() -> list:
    """The serve phase's grouped call first (the kernels line's row),
    then the TPU-layout cases: the same cells, a deeper all-float32 one
    and the smoke widths."""
    sc = mamba2_780m.SMOKE
    return [
        lambda: ssd_grouped_case(B=2, L=512, H=48, G=1, cs=128, p=64,
                                 n=128, bc_dtype=torch.bfloat16),
        lambda: ssd_case(B=2, NC=4, H=48, cs=128, p=64, n=128,
                         bc_dtype=torch.bfloat16),
        lambda: ssd_case(B=1, NC=8, H=48, cs=128, p=64, n=128,
                         bc_dtype=torch.float32),
        lambda: ssd_case(B=2, NC=3, H=sc.n_heads, cs=sc.chunk,
                         p=sc.head_dim, n=sc.d_state,
                         bc_dtype=torch.float32)]


def check_ssd() -> dict:
    """The SSD chunk kernel against its plain version at every case of
    ``ssd_cases``."""
    checks = []
    for make in ssd_cases():
        fn, args, nbytes, work, shape = make()
        y, s = fn(*args, impl="cuda")
        yr, sr = fn(*args, impl="ref")
        torch.cuda.synchronize()
        errs, rel = [], []
        for got, want in ((y, yr), (s, sr)):
            if got.dtype != want.dtype or got.shape != want.shape \
                    or not torch.isfinite(got).all():
                raise RuntimeError(f"ssd_chunk {shape}: output {got.dtype} "
                                   f"{tuple(got.shape)} or non-finite")
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            if err > SSD_TOL * scale:
                raise RuntimeError(f"ssd_chunk {shape}: max abs err {err} "
                                   f"beyond {SSD_TOL} x max|plain| {scale}")
            errs.append(err)
            rel.append(err / scale)
        b_ms, b_by = bound(nbytes, *work)
        row = {"shape": shape, "dtype": "float32 out",
               "max_abs_err": max(errs), "max_abs_err_y_states": errs,
               "err_over_max_plain_y_states": rel, "tol": SSD_TOL,
               "ms": median_ms(lambda: fn(*args, impl="cuda")),
               "plain_ms": median_ms(lambda: fn(*args, impl="ref")),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
               "library": "none: no single PyTorch call computes y and the "
                          "chunk states",
               "bytes": nbytes,
               "flops_by_type": {str(dt).removeprefix("torch."): f
                                 for f, dt in work}}
        emit({"phase": "kernel", "name": "ssd_chunk_fwd", **row})
        checks.append(row)
        del args, y, s, yr, sr
        _free()
    return {"name": "ssd_chunk_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:60",
            "checks": checks}


def _max_excess(got, want, tol) -> tuple[float, float]:
    d = (got.float().cpu() - want.float()).abs()
    return d.max().item(), (d - tol[0] - tol[1] * want.abs()).max().item()


def mamba2_reference() -> dict:
    """mamba2 SMOKE (float32) on the card through the SSD kernel: logits
    of a prefill and of decode steps against the CPU's, then the
    contiguous engine's greedy streams against the CPU naive loop's."""
    model = Mamba2LM(mamba2_780m.SMOKE)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    cpu_params = _to(params, "cpu")
    rng = np.random.default_rng(4)
    vocab = model.cfg.vocab
    ssd_chunk_grouped.launches = 0
    tok = rng.integers(0, vocab, (3, 21)).astype(np.int32)
    runs = {}
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        with torch.no_grad():
            cache = model.init_cache(3, 32, device=dev)
            lg, cache = model.prefill(p, torch.from_numpy(tok).to(dev), cache)
            out = [lg]
            for i in range(4):
                step = torch.from_numpy(tok[:, i:i + 1]).to(dev)
                lg, cache = model.decode_step(p, cache, step, None)
                out.append(lg)
        runs[dev] = torch.cat(out, 1)
    err, excess = _max_excess(runs["cuda"], runs["cpu"], MAMBA_REF_TOL)
    if excess > 0 or not torch.isfinite(runs["cuda"]).all():
        raise RuntimeError(f"mamba2_reference: logits differ by {err}")
    prompts = [rng.integers(0, vocab, n).tolist()
               for n in (5, 9, 9, 14, 3, 20)]
    budgets = (6, 4, 8, 3, 7, 5)
    eng = ServeEngine(model, params, EngineConfig(
        max_batch=4, max_seq=32, decode_block=4), device="cuda")
    comps = eng.generate([Request(tokens=p, max_new_tokens=g)
                          for p, g in zip(prompts, budgets, strict=True)])
    if ssd_chunk_grouped.launches == 0:
        raise RuntimeError("mamba2_reference did not go through the SSD "
                           "kernel")
    loop = NaiveLoop(model, cpu_params, device="cpu")
    for c, p, g in zip(comps, prompts, budgets, strict=True):
        want = loop.generate([p], g)[0].tolist()
        if c.tokens != want:
            raise RuntimeError(f"card {c.tokens} != cpu {want}")
    return {"phase": "mamba2_reference", "requests": len(comps),
            "tokens": sum(len(c.tokens) for c in comps), "match": True,
            "max_abs_logit_err": err, "logit_tol": MAMBA_REF_TOL,
            "ssd_launches": ssd_chunk_grouped.launches}


def mamba_requests(vocab: int, eos_req: int | None = None,
                   eos_id: int | None = None) -> list[Request]:
    return serve_requests(vocab, eos_req, eos_id, lens=MAMBA_LENS, seed=6)


def mamba2_serve(model, params) -> dict:
    cfg = model.cfg
    common, engine, launches = drive_serve(
        model, params, MAMBA_ENGINE, mamba_requests,
        {"ssd_chunk_fwd": ssd_chunk_grouped})
    if launches["ssd_chunk_fwd"] != cfg.n_layers * common["prefill_batches"]:
        raise RuntimeError(f"ssd_chunk_fwd launched {launches} for "
                           f"{common['prefill_batches']} prefill calls of "
                           f"{cfg.n_layers} layers")
    return {
        "phase": "mamba2_serve", **common, "d_inner": cfg.d_inner,
        "heads": cfg.n_heads, "d_state": cfg.d_state,
        "backend": "contiguous", "prompt_lens": list(MAMBA_LENS),
        "state_bytes": engine.pool.kv_bytes(),
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
    }


def ptxas(source: str) -> list[dict]:
    """Registers, static shared memory and spills of each kernel compiled
    from ``csrc/<source>.cu``, from ``nvcc -Xptxas -v`` in this run's
    build (empty when the library was already built); kernel names
    demangled by the toolchain's ``c++filt``."""
    found, fn = [], None
    for line in _build.build_logs.get(source, "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = {"kernel": m.group(1)}
            found.append(fn)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            fn["spill_stores"], fn["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            fn["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            fn["static_smem"] = int(smem.group(1)) if smem else 0
    cxxfilt = shutil.which("c++filt")
    if found and cxxfilt:
        names = subprocess.run(
            [cxxfilt], input="\n".join(f["kernel"] for f in found),
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.splitlines()
        for f, name in zip(found, names):
            # "void (anonymous namespace)::k<64, 2>(args)" -> "k<64, 2>"
            name = name.replace("(anonymous namespace)::", "")
            f["kernel"] = name.split("(")[0].removeprefix("void ")
    return found


def kernel_rows(kernels: list[dict], launches: dict) -> list[dict]:
    """The kernels line's rows: each kernel's first check (its path's own
    geometry and working dtype), its launches on the path's run, and
    ptxas's registers, shared memory and spills for its source."""
    rows = []
    for k in kernels:
        main_row = k["checks"][0]
        rows.append({
            "name": k["name"], "route": k["route"], "source": k["source"],
            "replaces": k["replaces"], "launches": launches[k["name"]],
            "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "shape": main_row["shape"], "dtype": main_row["dtype"],
            **({"launches_by_shape": k["launches_by_shape"]}
               if "launches_by_shape" in k else {}),
            "ptxas": ptxas(Path(k["source"]).stem),
            "checks": k["checks"],
        })
    return rows


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
          "wall_s": time.perf_counter() - t0})

    tiny = torch.zeros(16, device="cuda")
    emit({"phase": "timing", "floor_ms": median_ms(lambda: tiny.add_(1)),
          "what": "median_ms of one one-block elementwise kernel: the "
                  "launch and event overhead inside every kernel time"})
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
    del model, params
    _free()
    rows = kernel_rows(kernels, result["launches"])

    k, where, reckoned = int8_plan()
    kernels = [check_adam(), *check_int8(k, where)]
    emit(train_reference())
    plain, _ = train("dreamddp")
    emit(plain)
    int8, sess = train("dreamddp-int8", keep=True)
    emit(int8)
    int8_launches(kernels, reckoned, int8["quantize_rows_launches_by_shape"])
    emit(train_profile(sess, int8["ms_per_step"]))
    del sess
    _free()
    # each kernel's launches from the run of its own path: the
    # optimizer's from the default algo, the int8 kernels' from the
    # int8 run
    rows += kernel_rows(kernels, {
        "fused_adamw": plain["launches"]["fused_adamw"],
        "quantize_rows": int8["launches"]["quantize_rows"],
        "dequantize_rows": int8["launches"]["dequantize_rows"]})

    ssd = check_ssd()
    emit(mamba2_reference())
    model = Mamba2LM(mamba2_780m.CONFIG)        # full width and depth
    params = model.init(torch.Generator("cuda").manual_seed(0))
    if count_params(params) != model.param_count():
        raise RuntimeError("parameter count disagrees with the config")
    result = mamba2_serve(model, params)
    emit(result)
    emit(profile_decode(model, params, MAMBA_ENGINE,
                        mamba_requests(model.cfg.vocab), "mamba2_profile"))
    del model, params
    _free()
    rows += kernel_rows([ssd], result["launches"])

    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
