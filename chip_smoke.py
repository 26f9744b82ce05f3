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
   engine on the card (through both kernels, decode blocks as CUDA
   graph replays) must emit exactly the greedy tokens of the plain
   naive loop on the CPU, same weights.
5. ``graph_check`` — the decode block as a CUDA graph against the same
   body run eagerly (``cuda_graphs=False``), in lockstep: granite SMOKE
   on the paged and contiguous backends and mamba2 SMOKE on the
   contiguous one, greedy and with sampling requests; each block's
   logits **bitwise** equal, then streams and every ``EngineStats``
   counter equal, and the paged kernel's launches per replay exactly
   layers x ``decode_block``.
6. ``serve``   — granite-3-2b at full width and depth (40 layers, random
   bfloat16 weights from a seeded generator) serves 12 greedy requests
   (prompts of 64-512 tokens, 32 new tokens each, one with an EOS)
   through ``ServeEngine(kv_backend="paged")``, every decode block one
   graph replay.  The engine is built (its graphs captured) before the
   launch counters are set to 0; they are read just after the run.  A
   kernel's launches are its wrapper's count (prefill: flash) plus
   replays x the launches its graph holds (decode: paged), checked
   exactly against 40 x ``decode_block`` x replays.  Also reported:
   graphs captured, capture seconds, replays, masked ticks.
7. ``profile`` — decode blocks alone under ``torch.profiler``: device
   time per tick by kernel class (kernels inside graph replays; CUDA
   events around each block besides), the host's launch calls per
   block and the device's busy share, to set beside the serve phase's
   unprofiled ms per tick.
8. ``train_reference`` — granite-3-2b SMOKE (float32), W=2, H=5, 10
   steps of ``Session.fit`` for ``dreamddp`` and ``dreamddp-int8`` on the
   card (through the training kernels) and on the CPU (plain versions)
   from the same initial parameters and batches: per-step losses and
   final parameters within the float32 tolerances of ``TRAIN_REF_TOL``.
   ``Session.serve().generate(tokens, 4)`` (greedy, graphed on the card)
   equal on both before the fit, and after it equal to a CPU engine on
   the card session's own parameters; the second ``serve()`` returns
   the same engine and captures nothing.  The same job with
   ``period_exec="compiled"`` (the first period eager, then one CUDA
   graph replay a period): final state **bitwise** the card's pipeline
   run, losses equal (so within ``TRAIN_REF_TOL`` of the CPU run), fused
   AdamW 11 launches a step with replays reckoned in; and a compiled run
   with a checkpoint every period and a failure injected inside the
   second, restored in place, **bitwise** the uninterrupted one.
9. ``train``   — granite-3-2b at published widths, depth cut 40 -> 8 and
   workers 8 -> 4 (the worker-stacked state has to fit one card),
   bfloat16, ``Session(JobConfig(workers=4, period=5,
   batch_per_worker=4, seq=512, smoke=False))`` for 10 steps with
   ``dreamddp`` then ``dreamddp-int8``, each with ``period_exec``
   ``pipeline`` then ``compiled``, every run a fresh session.  Launch
   counters are set to 0 just before each ``fit`` and read just after;
   a compiled run's launches are the wrappers' counts less what they
   counted while capturing, plus replays x what the graph holds: fused
   AdamW must run 11 x steps, the int8 kernels in the int8 runs
   (``quantize_rows`` shape by shape as ``int8_plan`` reckons).  Reports
   ms/step (the second period's time / H: a replay when compiled),
   tokens/s, MFU, peak and reserved memory, the graph's capture seconds,
   replays, launches per replay and pool bytes, each period's wall time
   beside the span between CUDA events around it, and first and last
   loss (finite, falling).
10. ``train_profile`` — one more period of each int8 session (pipeline,
   then compiled: one replay) under ``torch.profiler``: device ms per
   step by kernel class, the device's kernels and copies per period and
   its busy share of the wall time.
11. ``kernel`` (SSD) — the SSD chunk kernel against its plain version,
   first as the Mamba-2 serve phase calls it (``ssd_chunk_grouped`` on
   the model's layout: B 2, Lp 512, 48 heads, 1 group, cs 128, p 64, n
   128; x float32, b and c bfloat16 views of one conv output), then in
   the TPU layout (``ssd_chunk``) at the same cells, at B 1 x NC 8 all
   float32 and at the smoke widths (cs 8, p 8, n 16), held to ``1e-4 *
   max|plain|`` for y and for the states.
12. ``mamba2_reference`` — mamba2 SMOKE (float32) served by the
   contiguous engine on the card (through the SSD kernel) must emit
   exactly the greedy tokens of the plain naive loop on the CPU, same
   weights, and its prefill and decode logits must agree within
   ``MAMBA_REF_TOL``.
13. ``mamba2_serve`` — mamba2-780m at full width and depth (48 layers,
   d_model 1536, random bfloat16 weights from a seeded generator) serves
   12 greedy requests (prompts of 100-1024 tokens, 32 new tokens each,
   one with an EOS) through ``ServeEngine`` on the contiguous backend,
   decode blocks as graph replays (which launch no kernel of the port).
   The grouped SSD entry's counter is set to 0 just before and read
   just after: 48 launches per prefill call.
14. ``mamba2_profile`` — its decode blocks alone under ``torch.profiler``.
15. ``sim`` — SimNet on the host: ``check_library`` for ``dreamddp``,
   ``plsgd-enp`` and ``flsgd`` and ``check_async_library``, every window
   passing; ``Session.simulate`` of every library scenario in both modes
   on granite-3-2b's analytic profile at published widths (each trace's
   fingerprint, virtual seconds and replans); then ``measured_profile``
   of granite-3-2b's units on the card (one full-width block, the
   embedding and the tied head with the loss, forward and backward,
   batch 4 x 512, bf16) and the ``drifting-bandwidth`` and ``hier-2tier``
   replays on it.
16. ``async_reference`` — granite SMOKE (float32) on the async runtime,
   4 workers in 2 datacenters, H = 5, 3 periods, a worker leaving and
   one joining: ``AsyncHierRunner`` on the card (through fused AdamW)
   against the CPU (plain versions) from one template and the same
   batches: equal op logs and trace fingerprints, losses and server
   params within ``TRAIN_REF_TOL["dreamddp"]``, fused AdamW exactly 11 x
   H per ``PeriodOp``; a run checkpointing every ``ASYNC_CKPT_EVERY``
   merges and a fresh runner restored from its middle checkpoint, both
   **bitwise** the uninterrupted card run.
17. ``async_train`` — the train phase's granite-3-2b (published widths,
   8 layers, 4 workers, bf16, 4 x 512 tokens a worker) on the async
   runtime: ``Session(JobConfig(algo="hier-async", ...)).fit(15)``, 3
   periods per worker on the static scenario.  The bytes are reckoned
   from the op log before the run (worker states, server, the most
   bases and deltas alive at once) and printed beside the measured
   peak.  Reports wall seconds, ms per worker-step (CUDA events around
   each period / H), ms per merge and per pull + delta, merges, the
   staleness histogram, peak and reserved bytes, the history's and the
   global model's first and last loss (finite, falling); fused AdamW's
   launches (counters set to 0 just before ``fit``, read just after)
   exactly 11 x H per ``PeriodOp``; then ``Session.serve().generate``
   on the broadcast global model.

18. ``kernel`` (MoE geometry) — the paged kernel (8 slots, 32/4 heads,
   head_dim 128, 34 blocks, kv_len <= 544) and the flash kernel (b 2 x
   s 256 and b 1 x s 512, 32/4 heads, head_dim 128, causal; SDPA with
   ``enable_gqa`` as the library time) against their plain versions,
   as in phase 3.
19. ``moe_reference`` — qwen3-moe SMOKE (float32) on the card (flash
   prefill, paged decode) against the CPU (plain versions), same
   weights: logits of the full forward, of a prefill and of four paged
   decode steps, and the loss, within ``MOE_REF_TOL``; every MoE call's
   top-k routing equal, a flip accepted only below ``MOE_FLIP_MARGIN``
   and reported with its margin; the engine's greedy streams on paged
   and contiguous KV (graphs on the card) equal; a 4-step 2-worker
   ``Session.fit`` from the same parameters: fingerprints equal, losses
   within ``TRAIN_REF_TOL["dreamddp"]``, one fused AdamW launch a leaf
   a step.
20. ``moe_serve`` — qwen3-moe-30b-a3b at published widths and full
   depth (48 layers, 128 experts top-8, 30,532,122,624 random bf16
   parameters from a seeded generator) serves the serve phase's 12
   requests through the same engine (paged, 8 slots, decode block 8,
   graphs), launches counted as in phase 6 (flash 48 per prefill call,
   paged 48 x ``decode_block`` a replay); beside the ms per tick, the
   tick's byte bound (every weight but the embedding table: the dense
   dispatch runs every expert) and its share; then ``moe_profile``,
   its decode blocks under ``torch.profiler``.
21. ``mla_reference`` — deepseek-v3 SMOKE (float32: MLA, the sigmoid
   MoE with a shared expert, MTP) on the card against the CPU, same
   weights: logits of the full forward, of a prefill and of four paged
   decode steps, and the loss with MTP, within ``MOE_REF_TOL``; every
   MoE call's routing under ``MOE_FLIP_MARGIN``; greedy streams on paged
   and contiguous KV (graphs on the card) equal, the engine holding no
   paged-kernel scratch; a 4-step 2-worker ``Session.fit`` under
   ``dreamddp`` and ``dreamddp-int8`` (fingerprints equal, losses within
   ``TRAIN_REF_TOL``, fused AdamW one launch a leaf a step, the int8
   kernels in the int8 fit, counters set to 0 just before each fit);
   neither attention kernel launched in the phase.  Then one MLA layer
   at published widths (128 heads, 0.75 GB float32): the absorbed
   decode of a token, contiguous and paged, against the expanded
   forward at its position, within ``MLA_ABSORB_TOL``.
22. ``mla_serve`` — deepseek-v3-671b at published widths, depth 61 -> 4
   (3 dense blocks, 1 MoE block of 256 experts top-8, the MTP block;
   26,721,155,072 random bf16 parameters) serves the serve phase's 12
   requests through the same engine (paged latents, graphs; neither
   attention kernel launches); beside the ms per tick, the tick's byte
   bound (every weight but the embedding table and the MTP block) and
   its share; then ``mla_profile``, its decode blocks under
   ``torch.profiler``.
23. ``kernel`` (Griffin geometry) — the flash kernel at recurrentgemma's
   local MQA (16/1 heads, head_dim 256, window 2048, causal): b 1 x s
   3072 (the window cuts inside a 32-key tile) and a ragged b 1 x s
   1500 below the window, SDPA with ``enable_gqa`` and a boolean window
   mask as the library time; the paged kernel over 8 lanes' rings of
   2048 keys seen as 16-key pages (``RGLM.ring_table``, kv_len up to
   3104 folded into (2048, 4096], the rings wrapped, lane 0 reading
   page 0), in bf16 and float32, as in phase 3.
24. ``rg_reference`` — recurrentgemma SMOKE (float32, window 8, GQA group
   4, head_dim 8) on the card (flash prefill, paged ring decode) against
   the CPU (plain versions), same weights: logits of the full forward,
   of a 13-token prefill (over the window) and of 12 decode steps (the
   rings wrap), and the loss, within ``RG_REF_TOL``; both attention
   kernels launched; the contiguous engine's greedy streams (graphs on
   the card) equal; a 4-step 2-worker ``Session.fit`` under
   ``dreamddp`` and ``dreamddp-int8`` as in phase 21.
25. ``rg_serve`` — recurrentgemma-9b at published widths and full depth
   (38 layers: 12 superblocks of (rec, rec, attn) and a 2-layer tail;
   8,578,519,040 random bf16 parameters from a seeded generator) serves
   12 greedy requests (prompts of 64-3072 tokens, three over the
   window, 32 new tokens each, one with an EOS) on the contiguous
   backend (8 slots, max_seq 3200, decode block 8, graphs).  Launches
   as in phase 6: flash 12 per prefill call, paged 12 x
   ``decode_block`` a replay.  Beside the ms per tick, its byte bound
   (every weight, the tied table read whole as the head, plus the ring
   keys and values the live lanes read, reckoned from the requests) and
   its share, the ring and state bytes; then ``rg_profile``, its decode
   blocks under ``torch.profiler``.

Then one ``{"kernels": [...]}`` line (each kernel's cases, the path
whose run gave its launches — ``serve``, ``train``, ``mamba2_serve``,
``moe_serve``, ``rg_serve`` — fused AdamW's on the async path too, as
``launches_async_train``, the training kernels' in ``mla_reference``'s
and ``rg_reference``'s fits as ``launches_mla_reference`` and
``launches_rg_reference``, and ptxas's registers, shared
memory and spills for its source), the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
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
from repro_torch.configs import (deepseek_v3_671b,  # noqa: E402
                                 granite_3_2b, mamba2_780m,
                                 qwen3_moe_30b_a3b, recurrentgemma_9b)
from repro_torch.core.partial_sync import (contiguous_ranges,  # noqa: E402
                                           worker_unstack)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.fused_adam_sync import fused_adamw  # noqa: E402
from repro_torch.kernels.int8_quant import (dequantize_rows,  # noqa: E402
                                            quantize_rows)
from repro_torch.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.kernels.ssd_scan import (ssd_chunk,  # noqa: E402
                                          ssd_chunk_grouped)
from repro_torch.models.layers import count_params  # noqa: E402
from repro_torch.models import mla as mla_mod  # noqa: E402
from repro_torch.models.mamba2 import Mamba2LM  # noqa: E402
from repro_torch.models.rglru import RGLM  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serve import (EngineConfig, NaiveLoop, Request,  # noqa: E402
                               SamplingParams, ServeEngine)
from repro_torch.serve.cache import prefill_scatter  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

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

def paged_case(dtype, *, mb, max_len, window=None, slots=8, seed=0,
               n_q=32, n_kv=8, hd=64):
    """Decode at granite-3-2b width by default: ``slots`` slots, 32/8
    heads, head_dim 64 (``n_q``/``n_kv``/``hd``: qwen3-moe's 32/4 and
    128), 16-token pages, ``mb`` blocks per slot, ragged kv_len up to
    ``max_len`` (one slot at one page, the last at ``max_len``)."""
    ps = 16
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
    shape = (f"slots {slots}, {n_q}/{n_kv} heads, hd {hd}, page 16, "
             f"max_blocks {mb}, kv_len <= {max_len}"
             + (f", window {window}" if window else ""))
    return args, {"window": window}, nbytes, flops, None, shape


def flash_case(dtype, *, b, s, window=None, seed=1, n_q=32, n_kv=8, hd=64):
    """Prefill at granite-3-2b width by default: 32/8 heads, head_dim 64
    (``n_q``/``n_kv``/``hd``: qwen3-moe's 32/4 and 128), causal,
    optionally with a local window."""
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

    shape = (f"b {b}, s {s}, {n_q}/{n_kv} heads, hd {hd}, causal"
             + (f", window {window}" if window else ""))
    return (q, k, v), {"causal": True, "window": window}, nbytes, flops, \
        library, shape


CASES = {"paged_attention": paged_case, "flash_attention": flash_case}


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.is_floating_point() else t


def check_kernel(name: str, cases: list[dict] | None = None) -> dict:
    """Every case (``KERNELS[name]["cases"]`` unless ``cases`` is given)
    in both dtypes: the kernel against its plain version in float32 on
    the same input values, then the times and the bound."""
    fn = KERNELS[name]["fn"]
    checks = []
    for geometry in cases or KERNELS[name]["cases"]:
        geometry = dict(geometry)
        make = geometry.pop("case", CASES[name])   # the kernel's default
        for dtype in DTYPES:
            args, kw, nbytes, flops, library, shape = \
                make(dtype, **geometry)
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
    f0 = flash_attention.launches
    comps = eng.generate([Request(tokens=p, max_new_tokens=g)
                          for p, g in zip(prompts, budgets, strict=True)])
    if flash_attention.launches == f0 or not eng.block_stats \
            .kernel_launches().get("paged_attention"):
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


GRAPH_LENS = (6, 6, 9, 12, 6, 3, 17)          # graph_check's prompts
GRAPH_BUDGETS = (5, 3, 7, 2, 6, 4, 9)


def graph_check() -> dict:
    """Each decode path's graphs against the same body run eagerly, in
    lockstep on the same requests (7 over 4 slots, decode block 4; the
    sampled case gives every other request temperature 1.5, top-k 20):
    logits bitwise equal after every block, then streams, finish reasons
    and ``EngineStats`` counters equal.  SMOKE configs, float32."""
    counters = ("requests_completed", "prompt_tokens", "generated_tokens",
                "decode_ticks", "prefill_batches", "admit_ticks",
                "slot_ticks_active", "slot_ticks_total")
    cases = []
    for family, backend in (("granite-3-2b", "paged"),
                            ("granite-3-2b", "contiguous"),
                            ("mamba2-780m", "contiguous")):
        model = DecoderLM(granite_3_2b.SMOKE) if family == "granite-3-2b" \
            else Mamba2LM(mamba2_780m.SMOKE)
        params = model.init(torch.Generator("cuda").manual_seed(0))
        cfg = EngineConfig(max_batch=4, max_seq=32, decode_block=4,
                           kv_backend=backend, page_size=8)
        for sampled in (False, True):
            rng = np.random.default_rng(7)
            reqs = [Request(tokens=rng.integers(0, model.cfg.vocab,
                                                n).tolist(),
                            max_new_tokens=g, request_id=i,
                            sampling=SamplingParams(
                                temperature=1.5, top_k=20, seed=i)
                            if sampled and i % 2 else SamplingParams())
                    for i, (n, g) in enumerate(zip(GRAPH_LENS,
                                                   GRAPH_BUDGETS,
                                                   strict=True))]
            graph = ServeEngine(model, params, cfg, device="cuda",
                                keep_logits=True)
            eager = ServeEngine(model, params, cfg, device="cuda",
                                cuda_graphs=False, keep_logits=True)
            done = {id(graph): [], id(eager): []}
            for eng in (graph, eager):
                for r in reqs:
                    eng.submit(dataclasses.replace(r))
            blocks = 0
            while graph.has_work or eager.has_work:
                for eng in (graph, eager):
                    done[id(eng)] += eng.step()
                torch.cuda.synchronize()
                if not torch.equal(graph.last_logits, eager.last_logits):
                    diff = (graph.last_logits.float()
                            - eager.last_logits.float()).abs().max().item()
                    raise RuntimeError(f"graph_check {family} {backend} "
                                       f"block {blocks}: logits differ by "
                                       f"up to {diff}")
                blocks += 1
            runs = [({c.request_id: c.tokens for c in done[id(e)]},
                     {c.request_id: c.finish_reason for c in done[id(e)]},
                     {k: getattr(e.stats, k) for k in counters})
                    for e in (graph, eager)]
            if runs[0] != runs[1]:
                raise RuntimeError(f"graph_check {family} {backend}: "
                                   f"{runs[0]} != {runs[1]}")
            bs = graph.block_stats
            want = {"paged_attention": model.cfg.n_layers * 4} \
                if backend == "paged" else {}
            if bs.replays != blocks or any(
                    held != want for held in bs.captured_launches.values()):
                raise RuntimeError(f"graph_check {family} {backend}: "
                                   f"{bs.replays} replays of {blocks} "
                                   f"blocks, graphs hold "
                                   f"{bs.captured_launches}, want {want}")
            cases.append({
                "arch": family, "backend": backend,
                "variant": "sampled" if sampled else "greedy",
                "blocks": blocks, "replays_by_variant": dict(bs.blocks),
                "masked_ticks": bs.masked_ticks(4),
                "captured_launches": bs.captured_launches,
                "capture_s": bs.capture_s, "bitwise_logits": True,
                "streams_equal": True,
                "tokens": runs[0][2]["generated_tokens"]})
            del graph, eager
    return {"phase": "graph_check", "cases": cases}


SERVE_LENS = (64, 64, 128, 128, 192, 256, 256, 320, 384, 384, 448, 512)
# the serve phases' engine: 8 slots, paged KV in 16-token pages, decode
# blocks of 8 ticks (one graph replay each)
SERVE_ENGINE = EngineConfig(max_batch=8, max_seq=544, decode_block=8,
                            kv_backend="paged", page_size=16)


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
    # the wrappers count eager launches (prefill); a graph replay
    # launches what its capture counted
    eager = {name: fn.launches for name, fn in kernels.items()}
    replayed = engine.block_stats.kernel_launches()
    launches = {name: eager[name] + replayed.get(fn.__name__, 0)
                for name, fn in kernels.items()}

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
    if launches and min(launches.values()) <= 0:
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
        **graph_numbers(engine),
        "eager_launches": eager, "replay_launches": replayed,
    }
    return common, engine, launches


def graph_numbers(engine) -> dict:
    """What the engine's decode graphs did: graphs captured, seconds to
    capture them, replays, ticks run with some lane live and fully
    masked ticks, the launches each graph holds."""
    bs = engine.block_stats
    return {"graphs_captured": bs.graphs,
            "capture_s": bs.capture_s, "replays": bs.replays,
            "replays_by_variant": dict(bs.blocks),
            "ticks_run": bs.ticks_run,
            "masked_ticks": bs.masked_ticks(engine.config.decode_block),
            "captured_launches": bs.captured_launches}


def serve(model, params, engine_cfg, phase: str = "serve") -> dict:
    common, engine, launches = drive_serve(
        model, params, engine_cfg, serve_requests,
        {"flash_attention": flash_attention,
         "paged_attention": paged_attention})
    per_replay = model.cfg.n_layers * engine_cfg.decode_block
    held = engine.block_stats.captured_launches
    if common["graphs_captured"] != 2 or any(
            h != {"paged_attention": per_replay} for h in held.values()) \
            or common["eager_launches"]["paged_attention"] != 0 \
            or launches["paged_attention"] != \
            per_replay * common["replays"]:
        raise RuntimeError(
            f"paged_attention: {launches['paged_attention']} launches "
            f"({common['eager_launches']['paged_attention']} eager) over "
            f"{common['replays']} replays of graphs holding {held}; want "
            f"{per_replay} a replay and none eager")
    return {
        "phase": phase, **common,
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


def _busy_ms(spans) -> float:
    """Milliseconds covered by the union of (start, end) microsecond
    intervals."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def profile_decode(model, params, engine_cfg, requests=None,
                   phase="profile") -> dict:
    """Decode blocks alone under ``torch.profiler``: 8 requests fill the 8
    slots, the first step (admission and one block) runs unprofiled, and
    every later step is pure decode, one graph replay each.  Device time
    is summed over the device-side events (kernels, copies) only, per
    kernel class; CUDA events around each step give its span on the
    device (host gaps inside the step included) as a second reading
    should the profiler see no kernel inside a replay.  The host's
    launch calls per block are counted by runtime API name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    engine = ServeEngine(model, params, engine_cfg, device="cuda")
    requests = requests or serve_requests(model.cfg.vocab)
    for r in requests[:engine_cfg.slots]:
        engine.submit(r)
    engine.step()
    ticks0 = engine.stats.slot_ticks_total
    blocks0 = engine.block_stats.replays
    torch.cuda.synchronize()
    events = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while engine.has_work:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            engine.step()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ticks = (engine.stats.slot_ticks_total - ticks0) // engine_cfg.slots
    blocks = engine.block_stats.replays - blocks0
    ms: dict[str, float] = {}
    count: dict[str, int] = {}
    host_calls: dict[str, int] = {}
    spans = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            if ev.name.startswith("cuda") and any(
                    k in ev.name for k in ("Launch", "Memcpy", "Memset")):
                host_calls[ev.name] = host_calls.get(ev.name, 0) + 1
            continue
        cls = _kernel_class(ev.name)
        ms[cls] = ms.get(cls, 0.0) + ev.time_range.elapsed_us() / 1e3
        count[cls] = count.get(cls, 0) + 1
        spans.append((ev.time_range.start, ev.time_range.end))
    if not count:
        raise RuntimeError(f"{phase}: the profiler saw no device event")
    event_ms = sum(a.elapsed_time(b) for a, b in events)
    return {
        "phase": phase, "window": "decode only", "ticks": ticks,
        "blocks": blocks,
        "masked_ticks": blocks * engine_cfg.decode_block - ticks,
        "device_ms_per_tick": sum(ms.values()) / ticks,
        "device_ms_per_tick_by_class": {k: v / ticks for k, v in ms.items()},
        "launches_per_tick_by_class": {k: v / ticks
                                       for k, v in count.items()},
        # a tick replays dozens of kernels; copies alone would be ~3 a block
        "profiler_sees_replayed_kernels": sum(
            v for k, v in count.items() if k != "memcpy/memset")
        >= blocks * engine_cfg.decode_block,
        "event_ms_per_tick": event_ms / ticks,
        "wall_ms_per_tick_profiled": wall_ms / ticks,
        "busy_share": _busy_ms(spans) / wall_ms,
        "host_calls_per_block": {k: v / blocks
                                 for k, v in host_calls.items()},
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


def train_job(algo: str, period_exec: str = "pipeline") -> JobConfig:
    return JobConfig(arch="granite-3-2b", algo=algo, workers=TRAIN_WORKERS,
                     period=TRAIN_H, batch_per_worker=TRAIN_B, seq=TRAIN_S,
                     smoke=False, period_exec=period_exec)


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


def check_int8_shapes(reckoned: dict, measured: list[dict], what: str
                      ) -> None:
    """Holds a run's ``quantize_rows`` launches by shape (``measured``,
    as the wrapper counted them, graph replays reckoned in) to
    ``int8_plan``'s reckoning."""
    counted = {tuple(e["shape"]): e["launches"] for e in measured}
    if counted != reckoned:
        raise RuntimeError(f"quantize_rows launched {counted} by shape in "
                           f"the {what}; the plan reckons {reckoned}")


def int8_launches(kernels: list[dict], reckoned: dict,
                  measured: list[dict]) -> None:
    """Puts the int8 run's ``quantize_rows`` launches by shape, as the
    wrapper counted them (``measured``), on its kernels-line entry and on
    each of its check rows, after holding them, shape by shape, to
    ``int8_plan``'s reckoning."""
    check_int8_shapes(reckoned, measured, "int8 run")
    counted = {tuple(e["shape"]): e["launches"] for e in measured}
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


def run_launches(runner) -> tuple[dict, list[dict]]:
    """The kernel launches a run made since ``_reset_train_counts``, by
    wrapper and (``quantize_rows``) by shape: the wrappers' counts, less
    what they counted while a period was captured (recorded, not run),
    plus graph replays x what each graph holds.  Each graph is captured
    once in a run here."""
    stats = runner.graph_stats
    if stats.graphs != len(stats.captured_launches):
        raise RuntimeError(f"{stats.graphs} captures for "
                           f"{len(stats.captured_launches)} make-up keys")
    counts = collections.Counter(_train_counts())
    shapes = collections.Counter(quantize_rows.launches_by_shape)
    for key, held in stats.captured_launches.items():
        n = stats.replays[key]
        for name, k in held.items():
            counts[name] += (n - 1) * k
        for shape, k in stats.captured_by_shape[key].items():
            shapes[shape] += (n - 1) * k
    return dict(counts), [{"shape": list(shape), "launches": n}
                          for shape, n in shapes.most_common() if n]


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
        serve = serve_reference(card, cpu)
        init = [x.clone() for x in tree_leaves(card.state.params)]
        _reset_train_counts()
        card.fit(10)
        counts = _train_counts()
        cpu.fit(10)
        serve.update(serve_after_fit(card))
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
                     "launches": counts, "tolerance": tol,
                     "serve": serve,
                     "compiled": compiled_reference(job, card, init)}
        del card, cpu
        _free()
    return out


def _state_leaves(state) -> list[torch.Tensor]:
    return [x for x in tree_leaves(state._asdict()) if x is not None]


def _bitwise(a, b, what: str) -> None:
    for x, y in zip(_state_leaves(a), _state_leaves(b), strict=True):
        if not torch.equal(x, y):
            raise RuntimeError(f"{what}: the states differ by up to "
                               f"{(x.float() - y.float()).abs().max().item()}")


def compiled_reference(job: JobConfig, card: Session, init: list) -> dict:
    """The train_reference job with ``period_exec="compiled"`` on the card
    from the same initial parameters: its final state **bitwise** the
    pipeline run's (``card``, already held to the CPU run), its losses
    equal; the first period eager, one capture, the second a replay;
    fused AdamW 11 launches a step, replays reckoned in.  Then a compiled
    run with a checkpoint every period and a failure injected at step 7,
    inside the second period: restored in place (the graph kept), it must
    end bitwise where the uninterrupted compiled run ends."""
    def session(**kw):
        sess = Session(job.replace(period_exec="compiled", **kw),
                       device="cuda")
        for x, y in zip(tree_leaves(sess.state.params), init, strict=True):
            x.copy_(y)
        return sess

    comp = session()
    _reset_train_counts()
    comp.fit(10)
    launches, _ = run_launches(comp.runner)
    stats = comp.runner.graph_stats
    _bitwise(card.state, comp.state, f"compiled {job.algo} against pipeline")
    if [h["loss"] for h in comp.history] != [h["loss"] for h in
                                             card.history]:
        raise RuntimeError(f"compiled {job.algo}: losses differ from the "
                           "pipeline's")
    if stats.graphs != 1 or stats.replays[()] != 1 \
            or launches["fused_adamw"] != 11 * 10:
        raise RuntimeError(f"compiled {job.algo}: {stats.graphs} graphs, "
                           f"{stats.replays} replays, launches {launches}")
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        again = session(ckpt_dir=str(ckpt_dir), ckpt_every=5)
        runner = again.runner
        state = runner.run(again.state, 10, fused=True, inject_failure_at=7)
        _bitwise(comp.state, state, f"compiled {job.algo} restart")
        if runner.retries != 1 or runner.graph_stats.graphs != 1 \
                or runner.ckpt.latest_step() != 10:
            raise RuntimeError(f"restart {job.algo}: retries "
                               f"{runner.retries}, graphs "
                               f"{runner.graph_stats.graphs}")
        restart = {"retries": runner.retries,
                   "graphs": runner.graph_stats.graphs,
                   "replays": runner.graph_stats.replays[()],
                   "history_steps": [h["step"] for h in runner.history],
                   "bitwise_equal_to_uninterrupted": True}
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"bitwise_equal_to_pipeline": True, "losses_equal": True,
            "graphs": stats.graphs, "replays": stats.replays[()],
            "capture_s": stats.capture_s, "pool_bytes": stats.pool_bytes,
            "launches_per_replay": stats.captured_launches[()],
            "launches": launches, "restart": restart}


def _serve_tokens(sess: Session) -> np.ndarray:
    return np.random.default_rng(9).integers(0, sess.model.cfg.vocab,
                                             (2, 8))


def serve_reference(card: Session, cpu: Session) -> dict:
    """Before the fit both sessions hold the same parameters:
    ``serve().generate(tokens, 4)`` (greedy; graph replays on the card)
    must give the same tokens on both."""
    tokens = _serve_tokens(card)
    engine = card.serve()
    got = engine.generate(tokens, 4)
    want = cpu.serve().generate(tokens, 4)
    if got.shape != (2, 4) or not torch.equal(got.cpu(), want):
        raise RuntimeError(f"Session.serve card {got.tolist()} != cpu "
                           f"{want.tolist()}")
    return {"tokens_before_fit": got.tolist(),
            "graphs_captured": engine.block_stats.graphs}


def serve_after_fit(card: Session) -> dict:
    """After the fit the parameters of the two sessions differ within the
    training tolerances, so greedy tokens may too: the card session's
    ``serve()`` (the same engine, its params copied in place, no new
    capture) is held to a CPU engine over a copy of the card session's
    own worker-0 parameters."""
    engine = card.serve()
    stats = engine.compile_stats()
    tokens = _serve_tokens(card)
    got = engine.generate(tokens, 4)
    if card.serve() is not engine or engine.compile_stats() != stats \
            or engine.block_stats.graphs != 2:
        raise RuntimeError("Session.serve() rebuilt its engine after fit")
    cpu_params = _to(worker_unstack(card.state.params, 0), "cpu")
    want = ServeEngine(card.model, cpu_params, EngineConfig(),
                       device="cpu").generate(tokens, 4)
    if not torch.equal(got.cpu(), want):
        raise RuntimeError(f"Session.serve after fit: card {got.tolist()} "
                           f"!= cpu {want.tolist()}")
    return {"tokens_after_fit": got.tolist(), "compile_stats": stats}


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


def train(algo: str, exec_: str, *, keep: bool = False):
    """One fresh full-width session with ``period_exec=exec_``,
    TRAIN_STEPS steps, counts around the fit (``compiled``: the first
    period eager, one capture, then a replay a period; launches reckoned
    by ``run_launches``).  Per period: its wall time and the span between
    the runner's CUDA events around it, whose ratio bounds the device's
    busy share from above (idle gaps inside the span count as busy)."""
    model = DecoderLM(TRAIN_MODEL)
    torch.cuda.reset_peak_memory_stats()
    sess = Session(train_job(algo, exec_), model=model, device="cuda")
    plan = sess.plan
    sess.state                                       # build the state
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated()
    _reset_train_counts()
    t0 = time.perf_counter()
    sess.fit(TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    runner = sess.runner
    counts, by_shape = run_launches(runner)
    stats = runner.graph_stats
    losses = [h["loss"] for h in sess.history]
    second = [h["time"] for h in sess.history[TRAIN_H:2 * TRAIN_H]]
    ms = statistics.median(second) * 1e3
    tokens = TRAIN_WORKERS * TRAIN_B * TRAIN_S
    flops = train_flops_per_step(model)
    periods = TRAIN_STEPS // TRAIN_H
    if counts["fused_adamw"] != 11 * TRAIN_STEPS:
        raise RuntimeError(f"train {algo} {exec_}: fused_adamw launched "
                           f"{counts['fused_adamw']} times, want "
                           f"{11 * TRAIN_STEPS}")
    if (algo == "dreamddp-int8") != (counts["quantize_rows"] > 0
                                     and counts["dequantize_rows"] > 0):
        raise RuntimeError(f"train {algo} {exec_}: int8 launches {counts}")
    if (stats.graphs, stats.replays[()]) != (
            (1, periods - 1) if exec_ == "compiled" else (0, 0)):
        raise RuntimeError(f"train {algo} {exec_}: {stats.graphs} graphs, "
                           f"{stats.replays} replays")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise RuntimeError(f"train {algo} {exec_}: losses {losses}")
    result = {
        "phase": "train", "algo": algo, "period_exec": exec_,
        "arch": TRAIN_MODEL.name,
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
        # period's time / H, so each figure is one period's mean; the
        # second period is a graph replay in the compiled mode
        "ms_per_step": ms, "ms_per_step_first_period":
            statistics.median(h["time"] for h in sess.history[:TRAIN_H])
            * 1e3,
        "ms_per_step_both_periods":
            statistics.fmean(h["time"] for h in sess.history) * 1e3,
        "period_wall_ms": [t * 1e3 for t in runner.period_times],
        "period_event_ms": [t * 1e3 for t in runner.period_event_times],
        "event_span_share": [e / t for e, t in zip(
            runner.period_event_times, runner.period_times, strict=True)],
        "tokens_per_s": tokens / (ms / 1e3),
        "flops_per_step": flops,
        "mfu": flops / (ms / 1e3) / PEAK_FLOPS[torch.bfloat16],
        "state_bytes": state_bytes,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "reserved_device_bytes": torch.cuda.memory_reserved(),
        "graphs": stats.graphs, "capture_s": stats.capture_s,
        "replays": stats.replays[()], "pool_bytes": stats.pool_bytes,
        "launches_per_replay": stats.captured_launches.get((), {}),
        "quantize_rows_launches_by_shape_per_replay": [
            {"shape": list(k), "launches": n} for k, n in
            stats.captured_by_shape.get((), collections.Counter())
            .most_common()],
        "first_loss": losses[0], "last_loss": losses[-1],
        "losses": losses, "launches": counts,
        "quantize_rows_launches_by_shape": by_shape,
    }
    if keep:
        return result, sess
    del sess, runner
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
    """One more period of ``sess`` under torch.profiler (in the compiled
    mode one graph replay, whose kernels the profiler sees): device ms
    per step by kernel class; the device's kernels and copies in the
    period; device ms in the step's optimizer and sync ranges
    (``repro_torch.optimizer``, ``repro_torch.sync``: kernels launched
    inside them, so none under a replay; the forward and backward are the
    rest); the share of the profiled wall time in which some kernel or
    copy ran (merged intervals); and device ms over the unprofiled step
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    replays = sess.runner.graph_stats.replays[()]
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
    busy = _busy_ms(spans)
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
        "phase": "train_profile", "algo": sess.cfg.algo,
        "period_exec": sess.cfg.period_exec, "steps": TRAIN_H,
        "replays_in_profile": sess.runner.graph_stats.replays[()] - replays,
        "wall_ms_per_step": wall * 1e3 / TRAIN_H,
        "device_events_per_period": sum(count.values()),
        "device_ms_per_step": device_ms,
        "device_ms_per_step_by_class": {k: v / TRAIN_H
                                        for k, v in ms.items()},
        "launches_per_step_by_class": {k: v / TRAIN_H
                                       for k, v in count.items()},
        "device_ms_per_step_by_range": ranges,
        "busy_share": busy / (wall * 1e3),
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
    if common["replay_launches"] or common["graphs_captured"] != 2:
        raise RuntimeError(f"mamba2 decode graphs: {common}")
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


# ------------------------------------------------- SimNet and async runtime

# The async phases' scenarios: 4 workers in 2 datacenters, H = 5, 3
# periods, one worker leaving at period 1 and one joining at period 2,
# links fast enough beside the smoke model's (analytic) compute that
# merges land between pulls and periods.
ASYNC_H, ASYNC_PERIODS = 5, 3
ASYNC_CKPT_EVERY = 4                   # merges between async checkpoints
SIM_ALGOS = ("dreamddp", "plsgd-enp", "flsgd")
# the async_train phase: train_job's geometry on the async runtime,
# 3 periods per worker on the static scenario
ASYNC_TRAIN_STEPS = 3 * TRAIN_H


def sim_job(workers: int = 8) -> JobConfig:
    """granite-3-2b at published widths and depth, the planning geometry
    of the train phase (4 x 512 tokens per worker, H = 5)."""
    return JobConfig(arch="granite-3-2b", algo="dreamddp", workers=workers,
                     period=TRAIN_H, batch_per_worker=TRAIN_B, seq=TRAIN_S,
                     smoke=False)


def block_thunks() -> list:
    """``measured_profile`` thunks for granite-3-2b's units at published
    widths on the card: one block (batch 4 x 512, bf16, random weights),
    the embedding and the tied head with the loss, each a forward and a
    backward (gradients of the inputs and the unit's weights) and a
    synchronize.  Every block unit is timed on its own call of that one
    block's thunk."""
    from repro_torch.models.layers import embed, gqa_attention, softmax_xent
    cfg = dataclasses.replace(granite_3_2b.CONFIG, n_layers=1)
    model = DecoderLM(cfg)
    gen = torch.Generator("cuda").manual_seed(11)
    params = model.init(gen)
    b, s, d = TRAIN_B, TRAIN_S, cfg.d_model
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                           device="cuda")
    positions = torch.arange(s, device="cuda").expand(b, s)
    x0 = torch.randn(b, s, d, generator=gen, device="cuda").to(cfg.dtype)

    def attend(_group, _i, p, h):
        q, k, v = model._project_qkv(p, h, positions)
        out = gqa_attention(q, k, v, q_positions=positions,
                            kv_positions=positions, causal=True,
                            window=cfg.window)
        return out.reshape(b, s, -1) @ p["wo"]["w"]

    def thunk(inputs, forward):
        def run():
            out = forward(*inputs)
            torch.autograd.grad(out.float().sum(), inputs)
            torch.cuda.synchronize()
        return run

    x = x0.detach().requires_grad_()
    # layer 0 of the one-layer stack; its leaves are inputs of the grad
    p = tree_map(lambda t: t[0].detach().requires_grad_(), params["blocks"])
    blk = tree_leaves(p)

    def block_fwd(x, *_):
        return model._block(attend, "blocks", "dense", 0, p, x)

    table = params["embed"]["table"].detach().requires_grad_()
    scale = params["head"]["norm"]["scale"].detach().requires_grad_()

    def head_fwd(x, scale, table):
        h = model._norm({"scale": scale}, x)
        return softmax_xent((h @ table.T)[:, :-1], tokens[:, 1:])

    costs = model.layer_costs(b, s)
    n_params = {name: n for name, n, _ in costs}
    out = [("embed", thunk([table], lambda t: embed({"table": t}, tokens)),
            n_params["embed"] * 2)]
    out += [(f"layer_{i}", thunk([x, *blk], block_fwd),
             n_params["layer_0"] * 2)
            for i in range(granite_3_2b.CONFIG.n_layers)]
    out.append(("head", thunk([x, scale, table], head_fwd),
                n_params["head"] * 2))
    return out


def sim() -> dict:
    """SimNet on the host: the conformance sweeps (every window must
    pass), then ``Session.simulate`` of every library scenario in both
    modes on granite-3-2b's analytic profile at published widths, then
    the drifting-bandwidth and hier-2tier replays on a profile measured
    on the card (``measured_profile``)."""
    from repro_torch.core.profiler import measured_profile
    from repro_torch.hier import check_async_library
    from repro_torch.sim import (available_scenarios, check_library,
                                 get_scenario)
    t0 = time.perf_counter()
    sync_reports = check_library(algos=SIM_ALGOS, H=4)
    async_reports = check_async_library()
    bad = [r.summary() for r in sync_reports + async_reports if not r.ok]
    if bad or not sync_reports or not async_reports:
        raise RuntimeError(f"SimNet conformance failed: {bad}")
    conformance_s = time.perf_counter() - t0

    def replay(sess, name, mode, profile=None):
        report = sess.simulate(name, mode=mode, profile=profile)
        trace = report.trace
        if not trace.iteration_spans or not math.isfinite(trace.makespan):
            raise RuntimeError(f"simulate {name} {mode}: empty trace")
        return {"fingerprint": trace.fingerprint(),
                "virtual_s": trace.makespan,
                "final_merge_s": trace.meta.get("final_merge_time"),
                "replans": len(report.plans) - 1,
                "plans": [plan.fingerprint() for _, plan in report.plans]}

    replays = {}
    for name in available_scenarios():
        sess = Session(sim_job(get_scenario(name).n_workers), device="cuda")
        replays[name] = {mode: replay(sess, name, mode)
                         for mode in ("sync", "async")}
    sess = Session(sim_job(), device="cuda")
    t0 = time.perf_counter()
    measured = measured_profile(block_thunks(), sess.hardware)
    profile_s = time.perf_counter() - t0
    _free()
    analytic = sess.profile()
    on_measured = {}
    for name in ("drifting-bandwidth", "hier-2tier"):
        msess = Session(sim_job(get_scenario(name).n_workers),
                        device="cuda")
        hw_profile = measured.with_bandwidth(
            msess.cfg.bandwidth, msess.cfg.latency, msess.cfg.workers)
        on_measured[name] = {mode: replay(msess, name, mode, hw_profile)
                             for mode in ("sync", "async")}
    layer = measured.layers[1]
    return {
        "phase": "sim", "conformance": {
            "sync_checks": len(sync_reports), "async_checks":
                len(async_reports), "algos": list(SIM_ALGOS),
            "all_windows_pass": True, "seconds": conformance_s,
            "max_rel_err": max(r.max_rel_err for r in
                               sync_reports + async_reports)},
        "model": "granite-3-2b (published widths, 40 layers)",
        "profile": "analytic (the reference's v5e planning constants)",
        "replays": replays,
        "measured_profile": {
            "what": "fwd+bwd per unit on the card, bf16, batch 4 x 512",
            "seconds": profile_s,
            "block_ms": (layer.t_fp + layer.t_bp) * 1e3,
            "embed_ms": (measured.layers[0].t_fp
                         + measured.layers[0].t_bp) * 1e3,
            "head_ms": (measured.layers[-1].t_fp
                        + measured.layers[-1].t_bp) * 1e3,
            "analytic_block_ms": (analytic.layers[1].t_fp
                                  + analytic.layers[1].t_bp) * 1e3,
        },
        "replays_on_measured_profile": on_measured,
    }


def async_scenario():
    from repro_torch.sim import LinkSpec, Scenario, WorkerJoin, WorkerLeave
    return Scenario(
        name="async-ref", description="4 workers, 2 DCs, leave and join",
        n_workers=4, n_datacenters=2,
        intra=LinkSpec(bandwidth=1e12, latency=1e-7, jitter=0.0),
        inter=LinkSpec(bandwidth=2e11, latency=1e-6, jitter=0.0),
        drift={}, events=(WorkerLeave(period=1, iteration=None, n=1),
                          WorkerJoin(period=2, iteration=None, n=1)),
        periods=ASYNC_PERIODS, seed=0)


def async_runner(device: str, params, *, ckpt=None, every: int = 0):
    """The async_reference runner: granite SMOKE (float32) from
    ``params``, adam as ``Session`` makes it, the host corpus."""
    from repro_torch.api.registry import get_strategy
    from repro_torch.core.profiler import HardwareSpec, analytic_profile
    from repro_torch.data import MarkovCorpus
    from repro_torch.hier import AsyncHierRunner, AsyncRunnerConfig
    from repro_torch.optim import make_optimizer
    model = DecoderLM(granite_3_2b.SMOKE)
    job = JobConfig()
    profile = analytic_profile(
        model.layer_costs(job.batch_per_worker, job.seq),
        HardwareSpec(bandwidth=1e12, latency=1e-7, n_workers=4))
    data = MarkovCorpus(vocab=model.cfg.vocab, seq_len=job.seq,
                        batch_per_worker=job.batch_per_worker, n_workers=4,
                        seed=0)
    opt = make_optimizer("adam", lr=job.lr, warmup_steps=job.warmup_steps,
                         decay_steps=job.decay_steps)
    return AsyncHierRunner(
        model, opt, get_strategy("hier-async"), data, profile=profile,
        scenario=async_scenario(), H=ASYNC_H, seed=0, ckpt=ckpt,
        run_cfg=AsyncRunnerConfig(ckpt_every_merges=every),
        params=_to(params, device), device=device)


def _async_bitwise(a, b, what: str) -> None:
    for x, y in zip(tree_leaves(a.server.state()),
                    tree_leaves(b.server.state()), strict=True):
        if not torch.equal(x, y):
            raise RuntimeError(f"{what}: server state differs")
    if sorted(a.states) != sorted(b.states):
        raise RuntimeError(f"{what}: workers {sorted(a.states)} != "
                           f"{sorted(b.states)}")
    for w in a.states:
        _bitwise(a.states[w], b.states[w], f"{what}, worker {w}")


def async_reference() -> dict:
    """Granite SMOKE (float32) on the async runtime, card (through fused
    AdamW) against CPU (plain versions) from the same template and
    batches: equal op logs and trace fingerprints, losses and server
    params within ``TRAIN_REF_TOL["dreamddp"]``, fused AdamW 11 x H
    launches per PeriodOp; then a run checkpointing every
    ASYNC_CKPT_EVERY merges, and a fresh card runner restored from its
    middle checkpoint, both **bitwise** the uninterrupted card run."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.hier import JoinOp, LeaveOp, PeriodOp
    tol = TRAIN_REF_TOL["dreamddp"]
    params = DecoderLM(granite_3_2b.SMOKE).init(
        torch.Generator("cuda").manual_seed(0))
    card = async_runner("cuda", params)
    cpu = async_runner("cpu", params)
    ops = card._schedule(ASYNC_PERIODS)[0]
    if [repr(o) for o in ops] != [repr(o) for o in
                                  cpu._schedule(ASYNC_PERIODS)[0]]:
        raise RuntimeError("async_reference: op logs differ")
    if not (any(isinstance(o, JoinOp) for o in ops)
            and any(isinstance(o, LeaveOp) for o in ops)):
        raise RuntimeError("async_reference: no join or leave in the log")
    periods = sum(isinstance(o, PeriodOp) for o in ops)
    _reset_train_counts()
    trace = card.run(ASYNC_PERIODS)
    torch.cuda.synchronize()
    launches = _train_counts()
    cpu_trace = cpu.run(ASYNC_PERIODS)
    if launches["fused_adamw"] != 11 * ASYNC_H * periods:
        raise RuntimeError(f"async_reference: fused_adamw launched "
                           f"{launches['fused_adamw']} times, want "
                           f"{11 * ASYNC_H * periods}")
    if trace.fingerprint() != cpu_trace.fingerprint():
        raise RuntimeError("async_reference: trace fingerprints differ")
    lc = np.array([h["loss"] for h in card.history])
    lp = np.array([h["loss"] for h in cpu.history])
    loss_err = float(np.max(np.abs(lc - lp) / np.abs(lp)))
    if not np.isfinite(lc).all() or loss_err > tol["loss_rtol"]:
        raise RuntimeError(f"async_reference: losses {lc} vs {lp}")
    worst, share = 0.0, 0.0
    for x, y in zip(tree_leaves(card.server.params),
                    tree_leaves(cpu.server.params), strict=True):
        d = (x.cpu() - y).abs()
        frac = (d > tol["bulk_atol"]).float().mean().item()
        if d.max().item() > tol["max_atol"] or frac > tol["share"]:
            raise RuntimeError(f"async_reference: server params differ by "
                               f"up to {d.max().item()}, {frac} beyond "
                               f"{tol['bulk_atol']}")
        worst, share = max(worst, d.max().item()), max(share, frac)
    ckpt_dir = ROOT / "build" / "chip_smoke_async_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        ck = async_runner("cuda", params,
                          ckpt=CheckpointManager(str(ckpt_dir), keep=100),
                          every=ASYNC_CKPT_EVERY)
        if ck.run(ASYNC_PERIODS).fingerprint() != trace.fingerprint():
            raise RuntimeError("async_reference: the checkpointing run's "
                               "trace differs")
        _async_bitwise(ck, card, "async checkpointing run")
        steps = sorted(int(d.name.split("_")[1]) for d in
                       ckpt_dir.iterdir() if d.name.startswith("step_"))
        mid = steps[len(steps) // 2]
        res = async_runner("cuda", params,
                           ckpt=CheckpointManager(str(ckpt_dir), keep=100))
        version = res.restore(step=mid)
        cursor = res.cursor
        if res.run(ASYNC_PERIODS).fingerprint() != trace.fingerprint():
            raise RuntimeError("async_reference: the restored run's trace "
                               "differs")
        _async_bitwise(res, card, "async restore")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"phase": "async_reference", "model": "granite-3-2b SMOKE f32",
            "workers": 4, "datacenters": 2, "H": ASYNC_H,
            "periods": ASYNC_PERIODS, "ops": len(ops),
            "period_ops": periods, "merges": card.server.version,
            "staleness_hist": card.server.staleness_hist,
            "fingerprint": trace.fingerprint(), "op_logs_equal": True,
            "losses_card": lc.tolist(), "max_loss_rel_err": loss_err,
            "max_param_abs_err": worst,
            "max_share_beyond_bulk_atol": share, "tolerance": tol,
            "launches": launches,
            "restore": {"checkpoints": steps, "restored_version": version,
                        "cursor": cursor, "bitwise_equal": True}}


def async_buffer_peak(ops) -> int:
    """Most float32 model-sized trees (bases and deltas) the runner holds
    at once over ``ops``: a pull adds a base, a period turns its base into
    the delta (kept while merges still name it), the last merge naming a
    delta frees it, a leave drops a base."""
    from repro_torch.hier import LeaveOp, MergeOp, PeriodOp, PullOp
    refs = collections.Counter((c[0], c[1]) for op in ops
                               if isinstance(op, MergeOp)
                               for c in op.contributors)
    bases, deltas, peak = set(), set(), 0
    for op in ops:
        if isinstance(op, PullOp):
            bases.add(op.worker)
        elif isinstance(op, PeriodOp):
            bases.discard(op.worker)
            if refs[op.worker, op.period]:
                deltas.add((op.worker, op.period))
        elif isinstance(op, MergeOp):
            for c in op.contributors:
                refs[c[0], c[1]] -= 1
                if not refs[c[0], c[1]]:
                    deltas.discard((c[0], c[1]))
        elif isinstance(op, LeaveOp):
            bases.discard(op.worker)
        peak = max(peak, len(bases) + len(deltas))
    return peak


def _timed(events: dict, name: str, fn):
    """``fn`` between two CUDA events, kept under ``name``."""
    def wrapper(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        events[name].append((start, end))
        return out
    return wrapper


def async_train() -> dict:
    """granite-3-2b at published widths, depth 8, bf16, on the async
    runtime through ``Session``: ``fit(15)`` (3 periods per worker on the
    static scenario), then ``serve().generate`` on the broadcast global
    model.  The bytes are reckoned from the op log before the run."""
    from repro_torch.hier import PeriodOp
    torch.cuda.reset_peak_memory_stats()
    job = train_job("hier-async")
    sess = Session(job, model=DecoderLM(TRAIN_MODEL), device="cuda")
    runner = sess.runner
    P = sess.model.param_count()
    ops = runner._schedule(ASYNC_TRAIN_STEPS // TRAIN_H)[0]
    periods = sum(isinstance(o, PeriodOp) for o in ops)
    peak_trees = async_buffer_peak(ops)
    reckoned = {
        "params": P,
        "workers_bf16_p_f32_m_v": job.workers * 10 * P,
        "server_f32_params_momentum_buffer": 12 * P,
        "bases_and_deltas_f32": peak_trees * 4 * P,
        "bases_and_deltas_live_at_most": peak_trees,
        "state_view_bf16": 2 * P, "one_worker_grads_bf16": 2 * P,
    }
    reckoned["total_without_activations"] = sum(
        v for k, v in reckoned.items()
        if k not in ("params", "bases_and_deltas_live_at_most"))
    if reckoned["total_without_activations"] > 70e9:
        raise RuntimeError(f"async_train reckons {reckoned} bytes; cut the "
                           "workers, not the widths")
    data = sess._data
    probe = {k: v[0].to("cuda") for k, v in data.batch(10_000).items()}

    def global_loss() -> float:
        with torch.no_grad():
            return sess.model.loss(worker_unstack(sess.state.params, 0),
                                   probe).item()

    loss0 = global_loss()
    events = collections.defaultdict(list)
    for name in ("_pull", "_period", "_delta", "_merge"):
        setattr(runner, name, _timed(events, name, getattr(runner, name)))
    torch.cuda.synchronize()
    _reset_train_counts()
    t0 = time.perf_counter()
    sess.fit(ASYNC_TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _train_counts()
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.memory_reserved()
    loss1 = global_loss()
    ms = {k: [s.elapsed_time(e) for s, e in v] for k, v in events.items()}
    if launches["fused_adamw"] != 11 * TRAIN_H * periods:
        raise RuntimeError(f"async_train: fused_adamw launched "
                           f"{launches['fused_adamw']} times, want "
                           f"{11 * TRAIN_H * periods}")
    hist = sorted(sess.history, key=lambda h: h["t_end"])
    losses = [h["loss"] for h in hist]
    if not (all(math.isfinite(x) for x in losses + [loss0, loss1])
            and losses[-1] < losses[0] and loss1 < loss0):
        raise RuntimeError(f"async_train: losses {losses}, global "
                           f"{loss0} -> {loss1}")
    tokens = np.random.default_rng(9).integers(0, TRAIN_MODEL.vocab, (2, 8))
    generated = sess.serve().generate(tokens, 4)
    if generated.shape != (2, 4):
        raise RuntimeError(f"async_train serve: {generated.shape}")
    pull_delta = [a + b for a, b in zip(ms["_pull"], ms["_delta"])]
    return {
        "phase": "async_train", "algo": job.algo, "arch": TRAIN_MODEL.name,
        "layers": TRAIN_LAYERS, "d_model": TRAIN_MODEL.d_model,
        "reduced": {"n_layers": "40 -> 8", "workers": "8 -> 4"},
        "dtype": TRAIN_MODEL.param_dtype, "workers": job.workers,
        "H": TRAIN_H, "batch_per_worker": TRAIN_B, "seq": TRAIN_S,
        "steps": ASYNC_TRAIN_STEPS, "period_ops": periods,
        "merges": runner.server.version,
        "staleness_hist": runner.server.staleness_hist,
        "wall_s": wall,
        "ms_per_worker_step": statistics.median(ms["_period"]) / TRAIN_H,
        "ms_per_worker_step_all": [t / TRAIN_H for t in ms["_period"]],
        "ms_per_merge": statistics.median(ms["_merge"]),
        "ms_per_merge_all": ms["_merge"],
        "ms_per_pull_plus_delta": statistics.median(pull_delta),
        "ms_per_pull": statistics.median(ms["_pull"]),
        "ms_per_delta": statistics.median(ms["_delta"]),
        "reckoned_bytes": reckoned,
        "peak_device_bytes": peak, "reserved_device_bytes": reserved,
        "history_first_loss": losses[0], "history_last_loss": losses[-1],
        "global_model_loss_before": loss0, "global_model_loss_after": loss1,
        "launches": launches, "serve_tokens": generated.tolist(),
    }


# ---------------------------------------------------------------- MoE

# qwen3-moe-30b-a3b at published widths and full depth: 48 layers, 128
# experts top-8 of width 768, 32/4 heads of width 128, bf16
MOE_PARAMS = 30_532_122_624
# the attention kernels at moe_serve's geometry (its max_seq 544 and
# admission groups of b <= 2, prompts up to 512): 32/4 heads, width 128
MOE_HEADS = {"n_q": 32, "n_kv": 4, "hd": 128}
MOE_CASES = {
    "paged_attention": [{"mb": 34, "max_len": 544, **MOE_HEADS}],
    "flash_attention": [{"b": 2, "s": 256, **MOE_HEADS},
                        {"b": 1, "s": 512, **MOE_HEADS}],
}
# moe_reference, card (kernels) against CPU (plain versions), float32
# smoke: logits and loss within atol + rtol * |cpu| (summation order of
# the float32 matmuls and of the attention kernels, <= 2e-5 a call)
MOE_REF_TOL = (1e-4, 1e-4)
# a layer's routing (its top-k experts) may differ between the card and
# the CPU only where the k-th router probability exceeds the (k+1)-th by
# less than this: 50x the ~2e-7 a float32 probability moves between the
# two (a flip at a larger margin is a fault, not rounding)
MOE_FLIP_MARGIN = 1e-5


@contextlib.contextmanager
def routing_record(store: list):
    """Record each MoE layer's routing while the model runs outside a
    graph: per token the top-k experts (sorted) and the margin between
    the k-th and the (k+1)-th router score, on the host."""
    from repro_torch.models import transformer
    real = transformer.moe_apply

    def recorded(p, cfg, x):
        logits = x.float() @ p["router"]["w"]
        scores = torch.softmax(logits, -1) if cfg.router == "softmax" \
            else torch.sigmoid(logits)
        top, idx = torch.topk(scores, cfg.top_k + 1, dim=-1)
        store.append((idx[..., :cfg.top_k].sort(-1).values.cpu(),
                      (top[..., cfg.top_k - 1] - top[..., cfg.top_k]).cpu()))
        return real(p, cfg, x)

    transformer.moe_apply = recorded
    try:
        yield
    finally:
        transformer.moe_apply = real


def _paged_from_lanes(model, cache, page_size: int):
    """A contiguous cache's lanes scattered into a fresh page pool (page
    0 the trash page), lane i into pages ``1 + i * nb ...``; returns the
    pool and its block tables."""
    leaf = next(iter(cache["blocks"].values()))    # GQA k or MLA c_kv
    b, depth = leaf.shape[1:3]
    nb = depth // page_size
    dev = leaf.device
    pages = model.init_paged_cache(1 + b * nb, page_size, device=dev)
    bt = torch.arange(1, 1 + b * nb, dtype=torch.int32,
                      device=dev).reshape(b, nb)
    prefill_scatter(pages, cache, bt, page_size)
    return pages, bt


def _moe_direct(model, params, toks: np.ndarray, feed: np.ndarray,
                device: str) -> tuple[dict, list]:
    """The smoke model on ``device`` outside the engine: logits of the
    full forward, the loss, a prefill (flash kernel on the card) and
    ``feed.shape[1]`` paged decode steps (paged kernel on the card) on
    the given tokens; with the routing of every MoE call."""
    b, s = toks.shape
    t = torch.from_numpy(toks).long().to(device)
    routes: list = []
    out = {}
    with torch.no_grad(), routing_record(routes):
        out["apply"] = model.apply(params, t)
        out["loss"] = model.loss(params, {"tokens": t, "labels": t})
        depth = s + feed.shape[1]
        depth += (-depth) % 8
        lg, cache = model.prefill(params, t, model.init_cache(
            b, depth, device=device))
        steps = [lg]
        pages, bt = _paged_from_lanes(model, cache, 8)
        active = torch.ones(b, dtype=torch.bool, device=device)
        for i in range(feed.shape[1]):
            tok = torch.from_numpy(feed[:, i:i + 1]).long().to(device)
            pos = torch.full((b,), s + i, dtype=torch.int32, device=device)
            lg, pages = model.decode_step_paged(params, pages, tok, pos, bt,
                                                active)
            steps.append(lg)
        out["prefill_decode"] = torch.cat(steps, 1)
    return {k: v.float().cpu() for k, v in out.items()}, routes


def smoke_direct(model, params, cpu_params, phase: str, seed: int
                 ) -> tuple[dict, np.random.Generator]:
    """A smoke model on the card against the CPU, same weights: logits of
    the full forward, of a prefill and of four paged decode steps, and
    the loss, within ``MOE_REF_TOL``; every MoE call's top-k routing
    equal, a flip accepted only below ``MOE_FLIP_MARGIN`` and reported
    with its margin.  Returns (the numbers, the generator whose draws
    made the tokens, for the phase's next draws)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, model.cfg.vocab, (3, 37)).astype(np.int64)
    feed = rng.integers(0, model.cfg.vocab, (3, 4)).astype(np.int64)
    card, card_routes = _moe_direct(model, params, toks, feed, "cuda")
    cpu, cpu_routes = _moe_direct(model, cpu_params, toks, feed, "cpu")
    out = {"phase": phase, "logit_tol": MOE_REF_TOL}
    for key in card:
        err, excess = _max_excess(card[key], cpu[key], MOE_REF_TOL)
        if excess > 0 or not torch.isfinite(card[key]).all():
            raise RuntimeError(f"{phase} {key}: differs by {err}")
        out[f"max_abs_err_{key}"] = err
    flips, min_margin = [], math.inf
    for call, ((ic, _), (ip, mp)) in enumerate(
            zip(card_routes, cpu_routes, strict=True)):
        min_margin = min(min_margin, mp.min().item())
        for where in (ic != ip).any(-1).nonzero().tolist():
            margin = mp[tuple(where)].item()
            flips.append({"call": call, "token": where, "margin": margin})
            if margin >= MOE_FLIP_MARGIN:
                raise RuntimeError(f"{phase}: routing flip at margin "
                                   f"{margin} (limit {MOE_FLIP_MARGIN}): "
                                   f"call {call}, token {where}")
    out.update({"moe_calls": len(cpu_routes), "routing_flips": flips,
                "min_topk_margin": min_margin,
                "flip_margin_limit": MOE_FLIP_MARGIN})
    return out, rng


def smoke_streams(model, params, cpu_params, phase: str,
                  rng: np.random.Generator,
                  backends=("paged", "contiguous")) -> dict:
    """Greedy streams of the engine on each of ``backends`` (graphs on
    the card), card against CPU: equal.  Returns tokens by backend."""
    prompts = [rng.integers(0, model.cfg.vocab, n).tolist()
               for n in (5, 9, 9, 14, 3, 20)]
    budgets = (6, 4, 8, 3, 7, 5)
    streams = {}
    for backend in backends:
        cfg = EngineConfig(max_batch=4, max_seq=32, decode_block=4,
                           kv_backend=backend, page_size=8)
        reqs = [Request(tokens=p, max_new_tokens=g)
                for p, g in zip(prompts, budgets, strict=True)]
        got = ServeEngine(model, params, cfg, device="cuda").generate(reqs)
        want = ServeEngine(model, cpu_params, cfg, device="cpu").generate(
            [dataclasses.replace(r) for r in reqs])
        a = [(c.tokens, c.finish_reason) for c in got]
        b = [(c.tokens, c.finish_reason) for c in want]
        if a != b:
            raise RuntimeError(f"{phase} {backend}: card {a} != cpu {b}")
        streams[backend] = sum(len(c.tokens) for c in got)
    return streams


def smoke_fit(arch: str, algo: str, params, cpu_params, phase: str
              ) -> dict:
    """A 4-step 2-worker ``Session.fit`` of ``arch``'s smoke config on
    the card and on the CPU from the same parameters: fingerprints
    equal, losses within ``TRAIN_REF_TOL[algo]``, one fused AdamW
    launch a leaf a step and the int8 kernels exactly when ``algo``
    syncs in int8 (counters set to 0 just before the card's fit)."""
    job = JobConfig(arch=arch, smoke=True, algo=algo, workers=2, period=2,
                    seq=32, batch_per_worker=2)
    _reset_train_counts()
    fit_card = Session(job, params=params, device="cuda").fit(4)
    counts = _train_counts()
    fit_cpu = Session(job, params=cpu_params, device="cpu").fit(4)
    if fit_card.plan.fingerprint() != fit_cpu.plan.fingerprint():
        raise RuntimeError(f"{phase} {algo}: plan fingerprints differ")
    lc = np.array([h["loss"] for h in fit_card.history])
    lp = np.array([h["loss"] for h in fit_cpu.history])
    loss_err = float(np.max(np.abs(lc - lp) / np.abs(lp)))
    if not np.isfinite(lc).all() \
            or loss_err > TRAIN_REF_TOL[algo]["loss_rtol"]:
        raise RuntimeError(f"{phase} {algo} fit: losses {lc} vs {lp}")
    n_leaves = len(tree_leaves(params))
    int8 = algo == "dreamddp-int8"
    int8_ran = counts["quantize_rows"] > 0 and counts["dequantize_rows"] > 0
    if counts["fused_adamw"] != n_leaves * 4 or int8_ran != int8:
        raise RuntimeError(f"{phase} {algo} fit: launches {counts}, want "
                           f"{n_leaves} fused AdamW a step"
                           f"{' and the int8 kernels' * int8}")
    return {"steps": 4, "fingerprint": fit_card.plan.fingerprint(),
            "losses_card": lc.tolist(), "max_loss_rel_err": loss_err,
            "launches": counts}


def moe_reference() -> dict:
    """qwen3-moe SMOKE (float32), card (the flash and paged kernels, the
    decode block as graph replays) against CPU (plain versions), same
    weights: :func:`smoke_direct` (through both kernels on the card),
    :func:`smoke_streams` and a ``dreamddp`` :func:`smoke_fit`."""
    model = DecoderLM(qwen3_moe_30b_a3b.SMOKE)
    cpu_params = model.init(torch.Generator().manual_seed(0))
    params = _to(cpu_params, "cuda")
    f0, p0 = flash_attention.launches, paged_attention.launches
    out, rng = smoke_direct(model, params, cpu_params, "moe_reference", 12)
    if flash_attention.launches == f0 or paged_attention.launches == p0:
        raise RuntimeError("moe_reference did not go through both kernels")
    out["stream_tokens_equal"] = smoke_streams(
        model, params, cpu_params, "moe_reference", rng)
    out["fit"] = smoke_fit("qwen3-moe-30b-a3b", "dreamddp", params,
                           cpu_params, "moe_reference")
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def moe_serve() -> tuple[dict, dict]:
    """qwen3-moe-30b-a3b at published widths and full depth, random bf16
    weights: the serve phase's requests and engine; then its decode
    blocks under the profiler.  Returns (serve result, profile)."""
    model = DecoderLM(qwen3_moe_30b_a3b.CONFIG)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    n = count_params(params)
    if not n == model.param_count() == MOE_PARAMS:
        raise RuntimeError(f"qwen3-moe parameters: {n}, the config counts "
                           f"{model.param_count()}, want {MOE_PARAMS}")
    result = serve(model, params, SERVE_ENGINE, phase="moe_serve")
    # what a tick must read: every weight but the embedding table (of
    # which it reads 8 rows), every expert included (the dense dispatch
    # runs each expert on its capacity slots); the KV read (at most the
    # pool's 0.43 GB) left out
    weight_bytes = sum(_nbytes(t) for t in tree_leaves(params)) \
        - _nbytes(params["embed"]["table"])
    expert_bytes = sum(_nbytes(params["blocks"]["mlp"][k])
                       for k in ("gate", "up", "down"))
    result.update({
        "experts": model.cfg.moe.n_experts, "top_k": model.cfg.moe.top_k,
        "tick_weight_bytes": weight_bytes,
        "tick_expert_bytes": expert_bytes,
        "bound_ms_per_tick": weight_bytes / HBM_BYTES_PER_S * 1e3,
        "share_of_bound": weight_bytes / HBM_BYTES_PER_S * 1e3
        / result["ms_per_decode_tick"],
    })
    profile = profile_decode(model, params, SERVE_ENGINE,
                             phase="moe_profile")
    del model, params
    _free()
    return result, profile


# ---------------------------------------------------------------- MLA

# deepseek-v3-671b at published widths, depth cut 61 -> 4: 3 dense blocks
# (d_ff 18432), 1 MoE block (256 experts top-8, a shared expert) and the
# MTP block, MLA of 128 heads throughout; bf16
MLA_MODEL = dataclasses.replace(deepseek_v3_671b.CONFIG, n_layers=4)
MLA_PARAMS = 26_721_155_072
# mla_reference's fits, each held to its TRAIN_REF_TOL
MLA_FIT_ALGOS = ("dreamddp", "dreamddp-int8")
# the absorbed decode against the expanded forward at published widths,
# float32 on the card (no TF32: torch's default for matmuls): the two
# associate the same products differently (q·(W_uk·c) against (q·W_uk)·c,
# and the combine through W_uv after or before the probabilities), each
# float32 sum of up to 16384 terms off by ~1e-6 of its magnitude
MLA_ABSORB_TOL = (1e-4, 1e-4)                        # atol, rtol


def mla_absorbed_check() -> dict:
    """One MLA layer of deepseek-v3 at published widths (128 heads,
    ranks 1536 / 512, nope 128, rope 64, v 128; 187M float32 parameters,
    0.75 GB) on the card: the absorbed decode of a token against the
    latents of the positions before it, on the contiguous and the paged
    layout, equals the expanded forward's output at that position, for
    two lanes at different positions (a masked tail in one)."""
    cfg, d = MLA_MODEL.mla, MLA_MODEL.d_model
    gen = torch.Generator("cuda").manual_seed(0)
    p = mla_mod.mla_init(gen, cfg, d, dtype=torch.float32)
    n = count_params(p)
    if n != mla_mod.mla_param_count(cfg, d):
        raise RuntimeError(f"MLA parameters {n}")
    b, s, ps = 2, 256, 16
    x = torch.randn((b, s, d), generator=gen, device="cuda")
    pos = torch.arange(s, device="cuda").expand(b, s)
    at = torch.tensor([s - 1, 100], dtype=torch.int32, device="cuda")
    rows = torch.arange(b, device="cuda")
    out = {"phase": "mla_absorbed", "params": n, "bytes": 4 * n,
           "lanes_at": at.tolist(), "tol": MLA_ABSORB_TOL}
    with torch.no_grad():
        full, lat = mla_mod.mla_apply_full(p, cfg, x, pos)
        want = full[rows, at.long()].cpu()
        xt = x[rows, at.long()][:, None]
        cache = {k: v.clone() for k, v in lat.items()}
        for k, v in cache.items():       # each lane holds [0, at) only
            v[pos >= at[:, None]] = 0
        got, _ = mla_mod.mla_decode(p, cfg, xt, cache, at)
        nb = s // ps
        bt = torch.arange(1, 1 + b * nb, dtype=torch.int32,
                          device="cuda").reshape(b, nb)
        pages = {k: torch.cat([torch.zeros_like(v[0, :ps])[None],
                               v.reshape(b * nb, ps, -1)])
                 for k, v in lat.items()}
        got_paged, _ = mla_mod.mla_decode_paged(
            p, cfg, xt, pages, bt, at,
            torch.ones(b, dtype=torch.bool, device="cuda"))
    for name, g in (("contiguous", got), ("paged", got_paged)):
        err, excess = _max_excess(g[:, 0], want, MLA_ABSORB_TOL)
        if excess > 0 or not torch.isfinite(g).all():
            raise RuntimeError(f"mla_absorbed {name}: differs by {err}")
        out[f"max_abs_err_{name}"] = err
    out["max_abs_expanded"] = want.abs().max().item()
    del p, x, full, lat, cache, pages
    _free()
    return out


def mla_reference() -> dict:
    """deepseek-v3 SMOKE (float32: MLA, the sigmoid MoE with a shared
    expert, MTP), card against CPU, same weights: :func:`smoke_direct`
    (the loss with MTP), :func:`smoke_streams` with the MLA engines
    holding no paged-kernel scratch, :func:`smoke_fit` under
    ``dreamddp`` and ``dreamddp-int8``; neither attention kernel
    launched in the phase; then :func:`mla_absorbed_check` at published
    widths."""
    attn0 = (flash_attention.launches, paged_attention.launches)
    model = DecoderLM(deepseek_v3_671b.SMOKE)
    cpu_params = model.init(torch.Generator().manual_seed(0))
    params = _to(cpu_params, "cuda")
    out, rng = smoke_direct(model, params, cpu_params, "mla_reference", 13)
    scratch = ServeEngine(model, params, EngineConfig(
        max_batch=4, max_seq=32, kv_backend="paged", page_size=8),
        device="cuda")._attn_scratch
    if scratch is not None:
        raise RuntimeError("mla_reference: the MLA engine allocated the "
                           "paged kernel's scratch")
    out["stream_tokens_equal"] = smoke_streams(
        model, params, cpu_params, "mla_reference", rng)
    out["fit"] = {algo: smoke_fit("deepseek-v3-671b", algo, params,
                                  cpu_params, "mla_reference")
                  for algo in MLA_FIT_ALGOS}
    attn = (flash_attention.launches, paged_attention.launches)
    if attn != attn0:
        raise RuntimeError(f"mla_reference: attention kernels launched "
                           f"(flash, paged) {attn0} -> {attn}")
    del params, cpu_params
    _free()
    out["absorbed"] = mla_absorbed_check()
    return out


def mla_serve() -> tuple[dict, dict]:
    """deepseek-v3-671b at published widths, depth 4 (3 dense + 1 MoE
    block + MTP; random bf16 weights): the serve phase's requests and
    engine, neither attention kernel launched; then its decode blocks
    under the profiler.  Returns (serve result, profile)."""
    model = DecoderLM(MLA_MODEL)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    n = count_params(params)
    if not n == model.param_count() == MLA_PARAMS:
        raise RuntimeError(f"deepseek-v3 parameters: {n}, the config counts "
                           f"{model.param_count()}, want {MLA_PARAMS}")
    attn0 = (flash_attention.launches, paged_attention.launches)
    common, engine, _ = drive_serve(model, params, SERVE_ENGINE,
                                    serve_requests, {})
    if engine._attn_scratch is not None \
            or common["graphs_captured"] != 2 or any(
                held for held in engine.block_stats.captured_launches
                .values()) \
            or (flash_attention.launches,
                paged_attention.launches) != attn0:
        raise RuntimeError(
            f"mla_serve: scratch {engine._attn_scratch is not None}, "
            f"graphs {common['graphs_captured']} holding "
            f"{engine.block_stats.captured_launches}, attention launches "
            f"{attn0} -> {(flash_attention.launches, paged_attention.launches)}")
    # what a tick must read: every weight but the embedding table (of
    # which it reads 8 rows) and the MTP block (training only), every
    # expert included (the dense dispatch runs each expert on its
    # capacity slots); the latent KV read (at most the pool's few MB)
    # left out
    weight_bytes = sum(_nbytes(t) for t in tree_leaves(params)) \
        - _nbytes(params["embed"]["table"]) \
        - sum(_nbytes(t) for t in tree_leaves(params["mtp"]))
    expert_bytes = sum(_nbytes(params["blocks"]["mlp"][k])
                       for k in ("gate", "up", "down"))
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    result = {
        "phase": "mla_serve", **common,
        "experts": model.cfg.moe.n_experts, "top_k": model.cfg.moe.top_k,
        "mla_heads": model.cfg.mla.n_heads,
        "peak_pages_in_use": engine.pool.peak_pages_in_use,
        "peak_kv_bytes": engine.pool.peak_kv_bytes(),
        "pool_bytes": engine.pool.kv_bytes(),
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "tick_weight_bytes": weight_bytes,
        "tick_expert_bytes": expert_bytes,
        "bound_ms_per_tick": bound_ms,
        "share_of_bound": bound_ms / common["ms_per_decode_tick"],
    }
    del engine
    _free()
    profile = profile_decode(model, params, SERVE_ENGINE,
                             phase="mla_profile")
    del model, params
    _free()
    return result, profile


# ---------------------------------------------------------------- Griffin

# recurrentgemma-9b at published widths and full depth: 12 superblocks of
# (rec, rec, attn) and a 2-layer rec tail, local MQA of 16 heads over one
# KV head of width 256 with a window of 2048, bf16
RG_PARAMS = 8_578_519_040
RG_HEADS = {"n_q": 16, "n_kv": 1, "hd": 256}
RG_WINDOW = recurrentgemma_9b.CONFIG.window
# rg_serve's prompts (three over the window, so prefill cuts it and the
# rings wrap in decode; the first 8 fill the slots, the profile's too)
RG_LENS = (3072, 64, 2304, 128, 256, 2560, 512, 1024, 384, 768, 1536, 2048)
RG_ENGINE = EngineConfig(max_batch=8, max_seq=3200, decode_block=8)


def ring_case(dtype, *, slots=8, window=RG_WINDOW, max_len=3104, seed=4,
              n_q=16, n_kv=1, hd=256):
    """Decode over each lane's ring of ``window`` keys seen as 16-key
    pages, as ``RGLM.decode_step`` reads it: the model's own table
    (``ring_table``) and ``kv_len`` folded into ``(window, 2 window]``;
    ragged ``kv_len`` up to ``max_len`` (lane 0 at 1, reading page 0;
    the last at ``max_len``, its ring wrapped)."""
    model = RGLM(dataclasses.replace(recurrentgemma_9b.CONFIG,
                                     window=window))
    ps = model.ring_page
    rng = np.random.default_rng(seed)
    kv_len = rng.integers(1, max_len + 1, size=slots)
    kv_len[0], kv_len[-1] = 1, max_len
    fold = np.where(kv_len > window, (kv_len - 1) % window + 1 + window,
                    kv_len)
    dev = "cuda"

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)) \
            .to(dev, dtype)

    table = model.ring_table(slots, dev)
    args = (rand(slots, n_q, hd), rand(slots * window // ps, ps, n_kv, hd),
            rand(slots * window // ps, ps, n_kv, hd), table,
            torch.tensor(fold, dtype=torch.int32, device=dev))
    es = torch.tensor([], dtype=dtype).element_size()
    tokens = int(np.minimum(kv_len, window).sum())
    nbytes = (2 * slots * n_q * hd * es
              + 2 * tokens * n_kv * hd * es
              + table.numel() * 4 + slots * 4)
    flops = 4.0 * n_q * hd * tokens
    shape = (f"slots {slots}, {n_q}/{n_kv} heads, hd {hd}, rings of "
             f"{window} as pages of {ps}, table {table.shape[1]}, kv_len <= "
             f"{max_len} folded, window {window}")
    return args, {"window": window}, nbytes, flops, None, shape


RG_CASES = {
    "flash_attention": [{"b": 1, "s": 3072, "window": RG_WINDOW,
                         **RG_HEADS},
                        {"b": 1, "s": 1500, "window": RG_WINDOW,
                         **RG_HEADS}],
    "paged_attention": [{"case": ring_case}],
}
# rg_reference, card (kernels) against CPU (plain versions), float32
# smoke: logits and loss within atol + rtol * |cpu| (summation order of
# the float32 matmuls and of the attention kernels, <= 2e-5 a call)
RG_REF_TOL = (1e-4, 1e-4)
RG_FIT_ALGOS = ("dreamddp", "dreamddp-int8")


def _rg_direct(model, params, toks: np.ndarray, feed: np.ndarray,
               device: str) -> dict:
    """The smoke model on ``device`` outside the engine: logits of the
    full forward, the loss, a prefill (flash kernel on the card) and
    ``feed.shape[1]`` decode steps over the rings (paged kernel on the
    card)."""
    b, s = toks.shape
    t = torch.from_numpy(toks).long().to(device)
    out = {}
    with torch.no_grad():
        out["apply"] = model.apply(params, t)
        out["loss"] = model.loss(params, {"tokens": t, "labels": t})
        lg, cache = model.prefill(params, t, model.init_cache(
            b, s + feed.shape[1], device=device))
        steps = [lg]
        for i in range(feed.shape[1]):
            tok = torch.from_numpy(feed[:, i:i + 1]).long().to(device)
            pos = torch.full((b,), s + i, dtype=torch.int32, device=device)
            lg, cache = model.decode_step(params, cache, tok, pos)
            steps.append(lg)
        out["prefill_decode"] = torch.cat(steps, 1)
    return {k: v.float().cpu() for k, v in out.items()}


def rg_reference() -> dict:
    """recurrentgemma SMOKE (float32), card (the flash and paged
    kernels, the decode block as graph replays) against CPU (plain
    versions), same weights: logits of the forward, of a prefill over
    the window and of 12 decode steps (the rings wrap) and the loss
    within ``RG_REF_TOL``, both kernels launched; the contiguous
    engine's greedy streams equal; :func:`smoke_fit` under ``dreamddp``
    and ``dreamddp-int8``."""
    model = RGLM(recurrentgemma_9b.SMOKE)
    cpu_params = model.init(torch.Generator().manual_seed(0))
    params = _to(cpu_params, "cuda")
    rng = np.random.default_rng(14)
    toks = rng.integers(0, model.cfg.vocab, (3, 13)).astype(np.int64)
    feed = rng.integers(0, model.cfg.vocab, (3, 12)).astype(np.int64)
    f0, p0 = flash_attention.launches, paged_attention.launches
    card = _rg_direct(model, params, toks, feed, "cuda")
    launched = {"flash_attention": flash_attention.launches - f0,
                "paged_attention": paged_attention.launches - p0}
    if min(launched.values()) <= 0:
        raise RuntimeError(f"rg_reference did not go through both kernels: "
                           f"{launched}")
    cpu = _rg_direct(model, cpu_params, toks, feed, "cpu")
    out = {"phase": "rg_reference", "logit_tol": RG_REF_TOL,
           "window": model.cfg.window, "prefill_len": toks.shape[1],
           "decode_steps": feed.shape[1], "kernel_launches": launched}
    for key in card:
        err, excess = _max_excess(card[key], cpu[key], RG_REF_TOL)
        if excess > 0 or not torch.isfinite(card[key]).all():
            raise RuntimeError(f"rg_reference {key}: differs by {err}")
        out[f"max_abs_err_{key}"] = err
    out["stream_tokens_equal"] = smoke_streams(
        model, params, cpu_params, "rg_reference", rng, ("contiguous",))
    out["fit"] = {algo: smoke_fit("recurrentgemma-9b", algo, params,
                                  cpu_params, "rg_reference")
                  for algo in RG_FIT_ALGOS}
    del params, cpu_params
    _free()
    return out


def rg_requests(vocab: int, eos_req: int | None = None,
                eos_id: int | None = None) -> list[Request]:
    return serve_requests(vocab, eos_req, eos_id, lens=RG_LENS, seed=7)


def rg_ring_read_bytes(model, comps) -> int:
    """The ring keys and values the live lanes read over a run, reckoned
    from its completions: a request of prompt length L emitting n tokens
    decodes at positions L .. L + n - 2, each attention layer reading
    min(pos + 1, window) keys and as many values."""
    cfg = model.cfg
    per_key = 2 * cfg.n_kv_heads * cfg.hd * torch.tensor(
        [], dtype=cfg.dtype).element_size() * cfg.n_super
    return per_key * sum(min(pos + 1, cfg.window)
                         for c in comps
                         for pos in range(c.n_prompt,
                                          c.n_prompt + len(c.tokens) - 1))


def rg_serve() -> tuple[dict, dict]:
    """recurrentgemma-9b at published widths and full depth, random bf16
    weights: ``RG_LENS``' requests on the contiguous engine (8 slots,
    decode block 8, graphs), flash launched 12 times a prefill call and
    paged 12 x ``decode_block`` a replay; then its decode blocks under
    the profiler.  Returns (serve result, profile)."""
    model = RGLM(recurrentgemma_9b.CONFIG)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    n = count_params(params)
    if not n == model.param_count() == RG_PARAMS:
        raise RuntimeError(f"recurrentgemma parameters: {n}, the config "
                           f"counts {model.param_count()}, want {RG_PARAMS}")
    cfg = model.cfg
    kernels = {"flash_attention": flash_attention,
               "paged_attention": paged_attention}
    common, engine, launches = drive_serve(model, params, RG_ENGINE,
                                           rg_requests, kernels)
    per_replay = cfg.n_super * RG_ENGINE.decode_block
    held = engine.block_stats.captured_launches
    if common["graphs_captured"] != 2 or engine._attn_scratch is None \
            or any(h != {"paged_attention": per_replay}
                   for h in held.values()) \
            or common["eager_launches"]["paged_attention"] != 0 \
            or launches["paged_attention"] != per_replay * common["replays"] \
            or launches["flash_attention"] != \
            cfg.n_super * common["prefill_batches"]:
        raise RuntimeError(
            f"rg_serve launches {launches} ({common['eager_launches']} "
            f"eager) over {common['replays']} replays of graphs holding "
            f"{held} and {common['prefill_batches']} prefill calls; want "
            f"paged {per_replay} a replay, flash {cfg.n_super} a prefill")
    # what a tick must read: every weight (the tied table whole, as the
    # head), plus the ring keys and values of the live lanes (their mean
    # over the run's ticks, reckoned from the requests)
    comps = engine.take_completed()
    weight_bytes = sum(_nbytes(t) for t in tree_leaves(params))
    ring_read = rg_ring_read_bytes(model, comps) / common["ticks_run"]
    bound_ms = (weight_bytes + ring_read) / HBM_BYTES_PER_S * 1e3
    arena = engine.pool.arena
    ring_bytes = sum(_nbytes(arena["blocks"][f"sub{j}"][name])
                     for j, kind in enumerate(cfg.pattern) if kind == "attn"
                     for name in ("k", "v", "pos"))
    result = {
        "phase": "rg_serve", **common, "backend": "contiguous",
        "window": cfg.window, "heads": f"{cfg.n_heads}/{cfg.n_kv_heads}",
        "head_dim": cfg.hd, "prompt_lens": list(RG_LENS),
        "max_seq": RG_ENGINE.max_seq,
        "ring_bytes": ring_bytes,
        "state_bytes": engine.pool.kv_bytes() - ring_bytes,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
        "tick_weight_bytes": weight_bytes,
        "tick_ring_read_bytes_mean": ring_read,
        "bound_ms_per_tick": bound_ms,
        "share_of_bound": bound_ms / common["ms_per_decode_tick"],
    }
    del engine
    _free()
    profile = profile_decode(model, params, RG_ENGINE,
                             rg_requests(cfg.vocab), "rg_profile")
    del model, params
    _free()
    return result, profile


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


def kernel_rows(kernels: list[dict], launches: dict, path: str
                ) -> list[dict]:
    """The kernels line's rows: each kernel's first check (its path's own
    geometry and working dtype), its launches on the path's run (the
    phase named by ``path``), and ptxas's registers, shared memory and
    spills for its source."""
    rows = []
    for k in kernels:
        main_row = k["checks"][0]
        rows.append({
            "name": k["name"], "route": k["route"], "source": k["source"],
            "replaces": k["replaces"], "path": path,
            "launches": launches[k["name"]],
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
    emit(graph_check())
    _free()
    model = DecoderLM(granite_3_2b.CONFIG)      # full width and depth
    params = model.init(torch.Generator("cuda").manual_seed(0))
    if count_params(params) != model.param_count():
        raise RuntimeError("parameter count disagrees with the config")
    result = serve(model, params, SERVE_ENGINE)
    emit(result)
    emit(profile_decode(model, params, SERVE_ENGINE))
    del model, params
    _free()
    rows = kernel_rows(kernels, result["launches"], "serve")

    k, where, reckoned = int8_plan()
    kernels = [check_adam(), *check_int8(k, where)]
    emit(train_reference())
    runs = {}
    for algo in ("dreamddp", "dreamddp-int8"):
        for exec_ in ("pipeline", "compiled"):
            int8_run = algo == "dreamddp-int8"
            result, sess = train(algo, exec_, keep=int8_run)
            emit(result)
            runs[algo, exec_] = result
            if int8_run:
                check_int8_shapes(reckoned,
                                  result["quantize_rows_launches_by_shape"],
                                  f"int8 {exec_} run")
                emit(train_profile(sess, result["ms_per_step"]))
                del sess
                _free()
    plain, int8 = runs["dreamddp", "pipeline"], runs["dreamddp-int8",
                                                     "pipeline"]
    int8_launches(kernels, reckoned, int8["quantize_rows_launches_by_shape"])
    # each kernel's launches from the run of its own path: the
    # optimizer's from the default algo, the int8 kernels' from the
    # int8 run
    rows += kernel_rows(kernels, {
        "fused_adamw": plain["launches"]["fused_adamw"],
        "quantize_rows": int8["launches"]["quantize_rows"],
        "dequantize_rows": int8["launches"]["dequantize_rows"]}, "train")

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
    rows += kernel_rows([ssd], result["launches"], "mamba2_serve")

    emit(sim())
    emit(async_reference())
    _free()
    result = async_train()
    emit(result)
    _free()
    for row in rows:            # the async path's launches of its kernel
        if row["name"] == "fused_adamw":
            row["launches_async_train"] = result["launches"]["fused_adamw"]

    kernels = [check_kernel(k, MOE_CASES[k]) for k in MOE_CASES]
    emit(moe_reference())
    _free()
    result, profile = moe_serve()
    emit(result)
    emit(profile)
    rows += kernel_rows(kernels, result["launches"], "moe_serve")

    result = mla_reference()
    emit(result)
    _free()
    for row in rows:            # the MLA slice's fits ran the train kernels
        if row["path"] == "train":
            row["launches_mla_reference"] = {
                algo: fit["launches"][row["name"]]
                for algo, fit in result["fit"].items()}
    result, profile = mla_serve()
    emit(result)
    emit(profile)
    _free()

    kernels = [check_kernel(k, RG_CASES[k]) for k in RG_CASES]
    result = rg_reference()
    emit(result)
    for row in rows:            # the Griffin slice's fits ran them too
        if row["path"] == "train":
            row["launches_rg_reference"] = {
                algo: fit["launches"][row["name"]]
                for algo, fit in result["fit"].items()}
    result, profile = rg_serve()
    emit(result)
    emit(profile)
    rows += kernel_rows(kernels, result["launches"], "rg_serve")

    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
