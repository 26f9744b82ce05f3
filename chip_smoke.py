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
5b. ``sync_check`` — ``repro_torch.lint`` over this tree's
   ``src/repro_torch`` (any finding outside the committed, empty
   baseline raises), then the lint held against the card: granite SMOKE
   on the paged engine with graphs (batched, then serial admission) and
   two replayed ``compiled`` periods of the smoke ``Session`` under
   ``torch.cuda.set_sync_debug_mode("warn")``, each synchronizing call's
   Python stack recorded.  A sync whose own line lies in a ``@hot_path``
   function and is neither a blessed explicit form (``.cpu()``,
   ``synchronize()``) nor pragma'd raises; syncs per decode block, per
   admission tick and per period are reported by kind and line, those
   reached through unmarked helpers (the static rule's blind spot)
   counted, not failed.
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
   ``MAMBA_REF_TOL``.  Then a 4-step 2-worker ``Session.fit`` under
   ``dreamddp`` and ``dreamddp-int8`` from the same parameters on card
   and CPU (fingerprints equal, losses within ``TRAIN_REF_TOL``, fused
   AdamW one launch a leaf a step, the int8 kernels in the int8 fit),
   and the ``dreamddp`` job for 6 steps (H = 2) with ``period_exec=
   "compiled"``: **bitwise** the card's pipeline run, one capture, two
   replays, a restart bitwise (``compiled_reference``).  No SSD launch
   in the fits: training runs the SSD einsum path.
13. ``mamba2_serve`` — mamba2-780m at full width and depth (48 layers,
   d_model 1536, random bfloat16 weights from a seeded generator) serves
   12 greedy requests (prompts of 100-1024 tokens, 32 new tokens each,
   one with an EOS) through ``ServeEngine`` on the contiguous backend,
   decode blocks as graph replays (which launch no kernel of the port).
   The grouped SSD entry's counter is set to 0 just before and read
   just after: 48 launches per prefill call.
14. ``mamba2_profile`` — its decode blocks alone under ``torch.profiler``.
14b. ``mamba2_train`` — mamba2-780m at published widths and full depth
   (48 layers, 780,148,992 bf16 parameters a worker) trained as the
   train phase trains granite: 4 workers, H = 5, 4 x 512 tokens a
   worker, 10 steps of ``dreamddp``, ``pipeline`` then ``compiled``;
   the same numbers as ``train`` (ms/step, tokens/s, MFU from
   ``Mamba2LM.layer_costs``, peak and state bytes, losses falling,
   fused AdamW one launch a leaf a step); the SSD chunk kernel is not
   on this path (no backward) and must not launch; then
   ``mamba2_train_profile``, one replayed period under the profiler.
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

26. ``kernel`` (Whisper geometry) — the flash kernel non-causal over
   1500 frames at 16/16 heads of width 64 (the encoder, b 2 and b 8 x
   1500 x 1500; the cross prefill, b 2 x 400 prompt rows over 1500) and
   causal (the decoder's self prefill, b 2 x 400), SDPA as the library
   time; the paged kernel over 8 contiguous lanes seen as pages
   (``WhisperModel.lane_table``): the cross lanes of 1500 frames as
   pages of 4 at kv_len 1500 and the self lanes of 448 as pages of 16,
   SDPA over the same lanes contiguous (a ``kv_len`` mask on the self
   lanes) as the library time; as in phase 3.
27. ``whisper_reference`` — whisper SMOKE (float32) on the card (flash
   encoder, cross and self prefill; paged self and cross decode)
   against the CPU, same weights and frames: logits of the full
   forward, of a prefill and of 6 decode steps, and the loss, within
   ``FRONTEND_REF_TOL``, both kernels launched; the contiguous engine's
   greedy streams (graphs on the card, each request with its frames)
   equal.
28. ``whisper_serve`` — whisper-medium at published widths and full
   depth (24 + 24 layers, 792,032,256 random bf16 parameters) serves 12
   greedy requests (prompts of 16-400 tokens, each with seeded frames
   [1500, 1024] float32, 32 new tokens, one with an EOS) on the
   contiguous backend (8 slots, lanes of 448, decode block 8, graphs).
   Launches as in phase 6: flash 72 a prefill call (24 encoder, 24 x 2
   decoder), paged 48 x ``decode_block`` a replay.  Beside the ms per
   tick, its byte bound (the decoder's weights but the cross ``wk`` and
   ``wv``, which decode never reads, the tied table whole,
   the live lanes' cross K/V and self K/V, reckoned from the requests)
   and its share; then ``whisper_profile``.
29. ``kernel`` (llava geometry) — the flash kernel at 56/8 heads (GQA
   group 7) of width 128, causal, b 2 x s 896 and b 1 x s 1088 (576
   patches and the prompt); the paged kernel at 8 slots, 56/8 x 128, 70
   blocks of 16, kv_len <= 1120; as in phase 3.
30. ``llava_reference`` — llava SMOKE (float32) with 8 patches a request
   on the card against the CPU: as phase 27, the decode steps paged,
   and the engine's streams on paged and contiguous KV.
31. ``llava_serve`` — llava-next-34b at published widths and full depth
   (60 layers, 34,388,917,248 random bf16 parameters, 68.78 GB drawn on
   the card a leaf slice at a time, after every earlier phase's memory
   is freed) serves the serve phase's 12 requests, each after seeded
   patch embeddings [576, 7168], through paged KV (pages of 16, 70 a
   lane, 8 slots, decode block 8, graphs): flash 60 a prefill call,
   paged 60 x ``decode_block`` a replay; the tick's byte bound (every
   weight but the embedding table, plus the live lanes' K/V) and its
   share; no depth cut; then ``llava_profile``.
31b. ``kernel`` (dense geometries), ``{qwen3,phi4,qwen25}_reference``
   and ``{qwen3,phi4,qwen25}_serve`` — for each of qwen3-1.7b (16/8
   heads, ``qk_norm``, tied), phi4-mini-3.8b (24/8, a 200,064-entry tied
   vocabulary) and qwen2.5-32b (40/8, QKV bias, untied; last, after
   every earlier phase's memory is freed): the flash kernel (b 2 x s 256,
   b 1 x s 512, causal) and the paged kernel (8 slots, 34 blocks, kv_len
   <= 544) at its heads and head width 128, as in phase 3; its SMOKE
   (float32) on the card against the CPU, as ``moe_reference``
   (``smoke_direct`` through both kernels, ``smoke_streams`` on paged
   and contiguous KV); then the config at published widths and full
   depth, random bf16 weights, ``count_params`` equal to the config's,
   serving the serve phase's 12 requests as phase 6 (flash one launch
   a layer a prefill call, paged layers x ``decode_block`` a replay,
   none eager); the tick's byte bound (every weight but the embedding
   table, of which a tick reads 8 rows; a tied table read whole as the
   head; plus the live lanes' K/V) and its share; then its decode
   blocks under the profiler (``*_profile``).
32. ``dryrun`` — the production dry run (``launch.dryrun.run_cell``) on
   meta tensors for ``DRYRUN_CELLS`` (granite-3-2b and mamba2-780m
   ``train_4k``, qwen3-moe-30b-a3b ``decode_32k`` on the multi-pod mesh,
   deepseek-v3-671b ``prefill_32k``): per-device FLOPs, memory and wire
   bytes and the H100 roofline's three terms (data-sheet constants), a
   line a cell.  Then ``dryrun_card``: granite-3-2b's decode (8 x 4096),
   prefill (4 x 2048) and train (8 layers as one worker, 4 x 512) cells,
   built by the port's ``build_*_cell`` on a one-device mesh, traced on
   meta tensors, materialized on the card from a seeded generator and
   called: predicted argument bytes against the allocation (the phase
   fails beyond ``ARG_BYTES_RTOL``), predicted peak against
   ``max_memory_allocated`` over one call and the roofline time against
   the call's held median, as ratios; the kernels each call launched
   (flash in prefill, fused AdamW in train).
33. ``grouped_gemm`` / ``moonlight_train`` — the held, dropless expert
   layer's grouped products (``grouped_gemm``) at the
   ``moonlight-train-dreamddp`` cell's shapes (``GROUPED_*``: 8192 x 6
   rows, 8 held experts, gate+up and down), in all three layouts, with
   the rows routed evenly, with empty groups and with one group holding
   every row: each against ``ref.py`` in float32 on the same bf16 values
   element by element at ``TOL[bfloat16]`` plus 16 sqrt(n) 2^-24 of the
   sum of the terms' sizes (float32 sums of n terms in another order; a
   wrong tile is off by the outputs' own size), rows past the last group
   and an empty group's dW
   exactly zero, then the kernel's, the plain version's and
   ``torch._grouped_mm``'s times and the bound of the rows routed.  Then
   Moonlight's smoke model in bfloat16 trained through the compiled
   runner (``Session.fit``, ``dreamddp``): ``grouped_gemm.launches``
   set to 0 just before the fit and read after, with the replays
   reckoned in, against 8 a MoE layer a worker step (forward, the
   checkpointed block's recomputed forward, dgrad and wgrad of both
   products), and ``routed_rows`` against every (token, choice) pair.

Then a ``wall`` line (the script's seconds from ``main``'s start),
one ``{"kernels": [...]}`` line (each kernel's cases, the path whose run
gave its launches — ``serve``, ``train``, ``mamba2_serve``,
``moe_serve``, ``rg_serve``, ``whisper_serve``, ``llava_serve``,
``qwen3_serve``, ``phi4_serve``, ``qwen25_serve``,
``moonlight_train`` — fused AdamW's on
the async path too, as ``launches_async_train``, and on Mamba-2 at
width as ``launches_mamba2_train``, the training kernels' in
``mla_reference``'s, ``rg_reference``'s and ``mamba2_reference``'s fits
as ``launches_mla_reference``, ``launches_rg_reference`` and
``launches_mamba2_reference``, the dry run's granite cells' as
``launches_dryrun``, and ptxas's registers, shared memory and spills
for its source), the ``nvidia-smi`` line, and last ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import ast
import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.api import JobConfig, Session  # noqa: E402
from repro_torch.configs import (deepseek_v3_671b,  # noqa: E402
                                 granite_3_2b, llava_next_34b, mamba2_780m,
                                 moonlight_16b_a3b, phi4_mini_3_8b,
                                 qwen2_5_32b, qwen3_1_7b, qwen3_moe_30b_a3b,
                                 recurrentgemma_9b, whisper_medium)
from repro_torch.core.partial_sync import (contiguous_ranges,  # noqa: E402
                                           worker_unstack)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_cost  # noqa: E402
from repro_torch.kernels.fused_adam_sync import (clip_partials,  # noqa: E402
                                                 clip_scale, clip_scale_ref,
                                                 fused_adamw)
from repro_torch.kernels.fused_adam_sync.ops import adamw_cost  # noqa: E402
from repro_torch.kernels.grouped_gemm import (grouped_cost,  # noqa: E402
                                              grouped_gemm, grouped_gemm_ref)
from repro_torch.kernels.int8_quant import (dequantize_rows,  # noqa: E402
                                            quantize_rows)
from repro_torch.kernels.int8_quant.ops import int8_cost  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.kernels.paged_attention.ops import paged_cost  # noqa: E402
from repro_torch.kernels.ssd_scan import (ssd_chunk,  # noqa: E402
                                          ssd_chunk_grouped)
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.launch import cells as dry_cells  # noqa: E402
from repro_torch.launch.dryrun import artifact, run_cell  # noqa: E402
from repro_torch.launch.mesh import MeshSpec  # noqa: E402
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
    # the keys this data needs: each slot's last min(kv_len, window)
    cost = paged_cost(args[0], args[1], args[3], tokens=int(
        np.minimum(kv_len, window or max_len).sum()))
    nbytes, flops = cost.nbytes, cost.flops
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
    cost = flash_cost(q, k, v, causal=True, window=window)
    nbytes, flops = cost.nbytes, cost.flops
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


LINT_BASELINE = ROOT / ".repro-torch-lint-baseline.json"
SYNC_WARNING = "synchronizing CUDA operation"  # set_sync_debug_mode's text


def sync_map() -> dict:
    """Per source file of the port, what the lint knows of its lines:
    ``hot`` — (first, last line, qualname) of each ``@hot_path``
    function; ``explicit`` — the lines of every statement that holds a
    blessed explicit sync (``.cpu()``, ``.to("cpu")``,
    ``synchronize()``); ``pragma`` — the lines of every statement a
    HOST-SYNC pragma covers."""
    from repro_torch.lint.engine import build_context, pragma_map
    from repro_torch.lint.rules.host_sync import is_explicit_sync
    out = {}
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        ctx = build_context(path.read_text(), path)
        pragmas = {line for line, rules in pragma_map(ctx.lines).items()
                   if rules & {"*", "HOST-SYNC"}}
        explicit, pragma = set(), set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.stmt) or isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef, ast.If, ast.For, ast.While,
                           ast.With, ast.Try)):
                continue
            span = set(range(node.lineno, node.end_lineno + 1))
            if any(isinstance(c, ast.Call) and is_explicit_sync(c, ctx)
                   for c in ast.walk(node)):
                explicit |= span
            if node.lineno in pragmas:
                pragma |= span
        out[str(path)] = {"hot": [(i.node.lineno, i.node.end_lineno,
                                   i.qualname) for i in ctx.hot_functions()],
                          "pragma": pragma, "explicit": explicit}
    return out


def _hot_name(smap: dict, frame) -> str | None:
    for a, b, qual in smap.get(frame.filename, {}).get("hot", ()):
        if a <= frame.lineno <= b:
            return qual
    return None


def classify_sync(smap: dict, stack) -> tuple[str, str, list[str]]:
    """One synchronizing call's (kind, own line, hot functions on its
    stack): ``explicit`` (its own line a blessed form), ``pragma`` (a
    HOST-SYNC pragma'd line of a hot function), ``unaccounted`` (any
    other line of a hot function: the lint missed it), ``via_helper``
    (a line of an unmarked helper reached from a hot function: the
    static rule's blind spot) or ``cold`` (reached from no hot
    function)."""
    port = [f for f in stack if f.filename in smap]
    hot = [q for q in (_hot_name(smap, f) for f in port) if q]
    if not port:
        return "cold", "chip_smoke.py", hot
    own = port[-1]
    info = smap[own.filename]
    where = f"{Path(own.filename).relative_to(ROOT)}:{own.lineno}"
    if own.lineno in info["explicit"]:
        return "explicit", where, hot
    if _hot_name(smap, own):
        kind = "pragma" if own.lineno in info["pragma"] else "unaccounted"
        return kind, where, hot
    return ("via_helper" if hot else "cold"), where, hot


@contextlib.contextmanager
def record_syncs(into: list):
    """Every synchronizing CUDA call inside, as its Python stack at the
    moment: ``torch.cuda.set_sync_debug_mode("warn")`` warns from the
    calling thread, so the stack is the caller's.  The mode does not
    flag ``torch.cuda.synchronize()`` itself, so that call is wrapped
    and recorded too."""
    def hook(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            into.append(traceback.extract_stack()[:-1])
        else:
            shown(message, category, filename, lineno, file, line)

    def synchronize(*args, **kwargs):
        into.append(traceback.extract_stack()[:-1])
        return device_sync(*args, **kwargs)

    device_sync = torch.cuda.synchronize
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning
        warnings.showwarning = hook
        torch.cuda.synchronize = synchronize
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield into
        finally:
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize = device_sync


def _sync_counts(smap: dict, stacks: list, group) -> dict:
    """Syncs by ``group(hot functions on the stack)``, by kind and by
    own line."""
    out: dict = {}
    for stack in stacks:
        kind, where, hot = classify_sync(smap, stack)
        g = out.setdefault(group(hot), {"syncs": 0, "by_kind": {},
                                        "by_line": {}})
        g["syncs"] += 1
        g["by_kind"][kind] = g["by_kind"].get(kind, 0) + 1
        g["by_line"][f"{where} {kind}"] = \
            g["by_line"].get(f"{where} {kind}", 0) + 1
    return out


def sync_check() -> dict:
    """(a) ``repro_torch.lint`` in-process over this tree's
    ``src/repro_torch``: any finding not in the committed baseline
    raises.  (b) The lint against the card: granite SMOKE served by the
    paged engine with graphs on (batched and serial admission: 7
    requests over 4 slots, every other one sampled, decode block 4) and
    two ``compiled`` periods of the smoke ``Session`` (W 2, H 5; after a
    warm fit that captured the period), under
    ``torch.cuda.set_sync_debug_mode("warn")``.  Each synchronizing call's stack is classified by
    :func:`classify_sync`; one whose own line lies in a ``@hot_path``
    function and is neither a blessed explicit form nor pragma'd
    raises.  Reports syncs per decode block, per admission tick and per
    period, by kind and by line."""
    from repro_torch.lint import baseline as lint_baseline
    from repro_torch.lint import lint_paths
    t0 = time.perf_counter()
    # paths as the CLI run from the root reports them (the baseline's)
    findings = lint_paths([os.path.relpath(ROOT / "src" / "repro_torch")])
    new, old = lint_baseline.partition(findings,
                                       lint_baseline.load(LINT_BASELINE))
    if new:
        raise RuntimeError("repro_torch.lint: " + "; ".join(
            f.render() for f in new))
    smap = sync_map()
    lint = {"findings": len(new), "baselined": len(old),
            "files": len(smap), "hot_functions": sum(
                len(v["hot"]) for v in smap.values()),
            "seconds": time.perf_counter() - t0}

    def serve_group(hot):
        if any(q.endswith(("._admit", "._admit_batch")) for q in hot):
            return "admit"
        return "decode" if "ServeEngine.step" in hot else "other"

    model = DecoderLM(granite_3_2b.SMOKE)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    serve_out = {}
    for batched in (True, False):
        cfg = EngineConfig(max_batch=4, max_seq=32, decode_block=4,
                           kv_backend="paged", page_size=8,
                           batched_admission=batched)
        engine = ServeEngine(model, params, cfg, device="cuda")
        rng = np.random.default_rng(7)
        reqs = [Request(tokens=rng.integers(0, model.cfg.vocab,
                                            n).tolist(),
                        max_new_tokens=g, request_id=i,
                        sampling=SamplingParams(temperature=1.5, top_k=20,
                                                seed=i)
                        if i % 2 else SamplingParams())
                for i, (n, g) in enumerate(zip(GRAPH_LENS, GRAPH_BUDGETS,
                                               strict=True))]
        stacks: list = []
        with record_syncs(stacks):
            comps = engine.generate(reqs)
        if len(comps) != len(reqs):
            raise RuntimeError("sync_check: the engine lost a request")
        blocks = sum(engine.block_stats.blocks.values())
        ticks = engine.stats.admit_ticks
        groups = _sync_counts(smap, stacks, serve_group)
        serve_out["batched" if batched else "serial"] = {
            "decode_blocks": blocks, "admit_ticks": ticks,
            "syncs_per_decode_block":
                groups.get("decode", {}).get("syncs", 0) / blocks,
            "syncs_per_admit_tick":
                groups.get("admit", {}).get("syncs", 0) / ticks,
            "groups": groups}
        del engine
    del model, params

    H = 5
    sess = Session(JobConfig(algo="dreamddp", workers=2, period=H,
                             period_exec="compiled"), device="cuda")
    sess.fit(2 * H)                  # period 1 eager, then the capture
    runner = sess.runner
    before = (len(runner.period_times),
              sum(runner.graph_stats.replays.values()))
    stacks = []
    with record_syncs(stacks):
        sess.fit(2 * H)
    periods = len(runner.period_times) - before[0]
    replays = sum(runner.graph_stats.replays.values()) - before[1]
    if periods != 2 or replays != periods:
        raise RuntimeError(f"sync_check: {periods} periods, {replays} "
                           "replays; want 2 replayed periods")
    groups = _sync_counts(
        smap, stacks,
        lambda hot: "period" if "Runner._run_fused" in hot else "other")
    train_out = {"periods": periods, "syncs_per_period":
                 groups.get("period", {}).get("syncs", 0) / periods,
                 "groups": groups}
    del sess
    _free()

    kinds = collections.Counter()
    for part in [*serve_out.values(), train_out]:
        for g in part["groups"].values():
            kinds.update(g["by_kind"])
    if kinds["unaccounted"]:
        raise RuntimeError(
            "sync_check: a sync in a @hot_path function that the lint "
            f"does not account for: serve {serve_out}, train {train_out}")
    return {"phase": "sync_check", "lint": lint, "serve": serve_out,
            "train": train_out, "by_kind": dict(kinds),
            "via_helpers": kinds["via_helper"],
            "unaccounted": kinds["unaccounted"]}


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


def drive_serve(model, params, engine_cfg, make_requests, kernels,
                frontend: str | None = None) -> tuple:
    """A warm-up run, then the timed run of ``make_requests(vocab,
    eos_req, eos_id)`` with the ``kernels``' launch counters set to 0
    just before and read just after; checks every stream.  ``frontend``
    goes to the engines (the requests then bring their extras).  Returns
    (the phase's common numbers, the engine, launches by kernel
    name)."""
    cfg = model.cfg
    # warm-up run (first launches, cuBLAS heuristics) whose streams also
    # pick the EOS: request 3 gets the 6th token it emits greedily
    warm = ServeEngine(model, params, engine_cfg, device="cuda",
                       frontend=frontend)
    base = warm.generate(make_requests(cfg.vocab))
    eos_req, eos_id = 3, base[3].tokens[5]
    del warm

    engine = ServeEngine(model, params, engine_cfg, device="cuda",
                         frontend=frontend)
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
        "arch": cfg.name,
        "layers": getattr(cfg, "n_layers", None)
        or cfg.n_enc_layers + cfg.n_dec_layers,
        "d_model": cfg.d_model,
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


def tick_weight_bytes(params, cfg, slots: int) -> int:
    """The weight bytes a decode tick must read: every weight once, but of
    an untied embedding table only the ``slots`` rows the tick embeds (a
    tied table is read whole as the head)."""
    table = params["embed"]["table"]
    total = sum(_nbytes(t) for t in tree_leaves(params))
    if cfg.tie_embeddings:
        return total
    return total - _nbytes(table) \
        + slots * table.shape[1] * table.element_size()


def full_params(model, want: int, phase: str):
    """Random bf16 weights for ``model`` at published widths and full
    depth, drawn on the card (seed 0); their count must equal the
    config's and ``want``."""
    params = model.init(torch.Generator("cuda").manual_seed(0))
    n = count_params(params)
    if not n == model.param_count() == want:
        raise RuntimeError(f"{phase} parameters: {n}, the config counts "
                           f"{model.param_count()}, want {want}")
    return params


def serve(model, params, engine_cfg, phase: str = "serve", *,
          make_requests=serve_requests, frontend: str | None = None,
          prefix: int = 0) -> dict:
    """:func:`drive_serve` over a decoder LM (``frontend`` and the
    ``prefix`` positions it puts before each prompt as the engine has
    them): flash one launch a layer a prefill call, paged layers x
    ``decode_block`` a replay and none eager; the pool's numbers and the
    tick's byte bound (:func:`tick_weight_bytes` plus the live lanes'
    K/V, ``pos + 1`` keys each, their mean over the run's ticks) over
    ``HBM_BYTES_PER_S``, and its share of the measured tick."""
    common, engine, launches = drive_serve(
        model, params, engine_cfg, make_requests,
        {"flash_attention": flash_attention,
         "paged_attention": paged_attention}, frontend=frontend)
    cfg = model.cfg
    per_replay = cfg.n_layers * engine_cfg.decode_block
    held = engine.block_stats.captured_launches
    if common["graphs_captured"] != 2 \
            or any(h != {"paged_attention": per_replay}
                   for h in held.values()) \
            or common["eager_launches"]["paged_attention"] != 0 \
            or launches["paged_attention"] != per_replay * common["replays"] \
            or launches["flash_attention"] != \
            cfg.n_layers * common["prefill_batches"]:
        raise RuntimeError(
            f"{phase} launches {launches} ({common['eager_launches']} "
            f"eager) over {common['replays']} replays of graphs holding "
            f"{held} and {common['prefill_batches']} prefill calls; want "
            f"paged {per_replay} a replay and none eager, flash "
            f"{cfg.n_layers} a prefill call")
    per_token = engine.pool.page_bytes() // engine_cfg.page_size
    positions = decode_positions(engine.take_completed(), prefix)
    kv_read = per_token * sum(p + 1 for p in positions) / common["ticks_run"]
    weight_bytes = tick_weight_bytes(params, cfg, engine_cfg.slots)
    bound_ms = (weight_bytes + kv_read) / HBM_BYTES_PER_S * 1e3
    return {
        "phase": phase, **common,
        "backend": engine_cfg.kv_backend,
        "heads": f"{cfg.n_heads}/{cfg.n_kv_heads}", "head_dim": cfg.hd,
        "max_seq": engine_cfg.max_seq,
        "peak_pages_in_use": engine.pool.peak_pages_in_use,
        "peak_kv_bytes": engine.pool.peak_kv_bytes(),
        "pool_bytes": engine.pool.kv_bytes(),
        "weight_bytes": sum(_nbytes(t) for t in tree_leaves(params)),
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "kv_bytes_per_token": per_token,
        "tick_weight_bytes": weight_bytes,
        "tick_kv_read_bytes_mean": kv_read,
        "bound_ms_per_tick": bound_ms,
        "share_of_bound": bound_ms / common["ms_per_decode_tick"],
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
                   phase="profile", frontend: str | None = None) -> dict:
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
    engine = ServeEngine(model, params, engine_cfg, device="cuda",
                         frontend=frontend)
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


def train_job(algo: str, period_exec: str = "pipeline",
              arch: str = "granite-3-2b") -> JobConfig:
    return JobConfig(arch=arch, algo=algo, workers=TRAIN_WORKERS,
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
    cost = adamw_cost(p)                        # p, m, v in+out; g in
    return (p, g, m, v, hyper), cost.nbytes, cost.flops


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


def check_clip() -> dict:
    """The clip folded into AdamW, on the largest leaf with bfloat16 p
    and g (the train phase's): the norm kernel against a float64 sum of
    squares, then timed against its byte bound (g read once) and the
    plain composition (the float32 cast and ``torch.dot``); the scaled
    AdamW on bfloat16 g against the plain version, then timed against
    its bound (22 B an element) and against what it replaces (the cast,
    ``* scale`` and the float32-g kernel)."""
    shape = (TRAIN_WORKERS, TRAIN_LAYERS, TRAIN_MODEL.d_model,
             TRAIN_MODEL.d_ff)
    dtype = torch.bfloat16
    args, _, flops = adam_case(dtype, shape)
    p, g32, m, v, hyper = args
    g = g32.mul_(3.0).to(dtype)
    del g32
    _free()
    scratch = torch.empty(clip_partials([g]) + 2, device="cuda")
    scale = clip_scale([g], 1.0, scratch)
    torch.cuda.synchronize()
    want = float((g.double() ** 2).sum())
    norm_err = abs(float(scratch[-1]) - want) / want
    if norm_err > 1e-6:
        raise RuntimeError(f"clip_scale: sum of squares off by {norm_err}")
    n = g.numel()
    norm_ms = median_ms(lambda: clip_scale([g], 1.0, scratch))
    norm_plain_ms = median_ms(lambda: clip_scale_ref([g], 1.0), reps=10)
    norm_bound, norm_by = bound(n * g.element_size(), (2.0 * n, torch.float32))
    a = [p.clone(), g, m.clone(), v.clone()]
    b = [p.clone(), g, m.clone(), v.clone()]
    fused_adamw(*a, hyper, scale=scale, impl="cuda")
    fused_adamw(*b, hyper, scale=scale, impl="ref")
    torch.cuda.synchronize()
    err, excess = 0.0, -1.0
    for x, y in zip(a, b, strict=True):
        atol, rtol = ADAM_TOL[x.dtype]
        d = (x.float() - y.float()).abs()
        err = max(err, d.max().item())
        excess = max(excess, (d - atol - rtol * y.float().abs()).max().item())
    if excess > 0:
        raise RuntimeError(f"fused_adamw bf16 g, scaled: max abs err {err} "
                           f"beyond its tolerance")
    del b
    _free()
    ms = median_ms(lambda: fused_adamw(*a, hyper, scale=scale, impl="cuda"))
    nbytes = adamw_cost(p, g).nbytes
    b_ms, b_by = bound(nbytes, (flops, torch.float32))

    def replaced():
        gf = g.float() * scale
        fused_adamw(a[0], gf, a[2], a[3], hyper, impl="cuda")

    replaced_ms = median_ms(replaced, reps=10)
    row = {"phase": "kernel", "name": "clip_in_fused_adamw",
           "shape": f"{list(shape)} (blocks.mlp.gate.w), {n} elements",
           "dtype": "bfloat16 p and g",
           "norm_rel_err": norm_err, "norm_ms": norm_ms,
           "norm_bound_ms": norm_bound, "norm_bound_by": norm_by,
           "norm_plain_ms": norm_plain_ms,
           "adamw_max_abs_err": err, "adamw_ms": ms,
           "adamw_bound_ms": b_ms, "adamw_bound_by": b_by,
           "adamw_bytes": nbytes,
           "replaced_ms": replaced_ms,
           "replaced": "g.float() * scale, then fused_adamw on float32 g"}
    del a, args, p, g, m, v
    _free()
    return row


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
        quant, dequant = ((cost.nbytes, cost.flops) for cost in (
            int8_cost("quantize_rows", r, c),
            int8_cost("dequantize_rows", r, c)))
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
                 "none: no single PyTorch call", *quant),
                ("dequantize_rows",
                 lambda: dequantize_rows(q, s, impl="cuda"),
                 lambda: dequantize_rows(q, s, impl="ref"), torch_mul,
                 "torch.mul(q, scale)", *dequant)):
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
    fused_adamw.scaled_launches = 0
    clip_scale.launches = 0
    quantize_rows.launches = 0
    quantize_rows.launches_by_shape.clear()
    dequantize_rows.launches = 0


def _train_counts() -> dict:
    return {"fused_adamw": fused_adamw.launches,
            "fused_adamw_scaled": fused_adamw.scaled_launches,
            "clip_scale": clip_scale.launches,
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


def compiled_reference(job: JobConfig, card: Session, init: list, *,
                       steps: int = 10) -> dict:
    """``job`` with ``period_exec="compiled"`` on the card for ``steps``
    steps from the same initial parameters ``init`` (worker-stacked
    leaves): its final state **bitwise** the pipeline run's (``card``,
    already fitted ``steps`` steps and held to the CPU run), its losses
    equal; the first period eager, one capture, then a replay a period;
    fused AdamW one launch a leaf a step (granite SMOKE: 11), replays
    reckoned in.  Then a compiled run with a checkpoint every period and
    a failure injected inside the second period (step 7 at H = 5):
    restored in place (the graph kept), it must end bitwise where the
    uninterrupted compiled run ends."""
    H = job.period

    def session(**kw):
        sess = Session(job.replace(period_exec="compiled", **kw),
                       device="cuda")
        for x, y in zip(tree_leaves(sess.state.params), init, strict=True):
            x.copy_(y)
        return sess

    comp = session()
    _reset_train_counts()
    comp.fit(steps)
    launches, _ = run_launches(comp.runner)
    stats = comp.runner.graph_stats
    _bitwise(card.state, comp.state, f"compiled {job.algo} against pipeline")
    if [h["loss"] for h in comp.history] != [h["loss"] for h in
                                             card.history]:
        raise RuntimeError(f"compiled {job.algo}: losses differ from the "
                           "pipeline's")
    if stats.graphs != 1 or stats.replays[()] != steps // H - 1 \
            or launches["fused_adamw"] != len(init) * steps:
        raise RuntimeError(f"compiled {job.algo}: {stats.graphs} graphs, "
                           f"{stats.replays} replays, launches {launches}")
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        again = session(ckpt_dir=str(ckpt_dir), ckpt_every=H)
        runner = again.runner
        state = runner.run(again.state, steps, fused=True,
                           inject_failure_at=H + max(1, H // 2))
        _bitwise(comp.state, state, f"compiled {job.algo} restart")
        if runner.retries != 1 or runner.graph_stats.graphs != 1 \
                or runner.ckpt.latest_step() != steps:
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
    return {"steps": steps, "H": H,
            "bitwise_equal_to_pipeline": True, "losses_equal": True,
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


class TrainSpec(NamedTuple):
    """What :func:`train` trains: the model, its FLOPs a step of every
    worker, its cuts of the published config, and the phase's name."""
    model: object
    flops_fn: Callable
    reduced: dict
    phase: str


GRANITE_TRAIN = TrainSpec(DecoderLM(TRAIN_MODEL), train_flops_per_step,
                          {"n_layers": "40 -> 8", "workers": "8 -> 4"},
                          "train")


def train(algo: str, exec_: str, *, keep: bool = False,
          spec: TrainSpec = GRANITE_TRAIN):
    """One fresh session with ``period_exec=exec_`` training
    ``spec.model``, TRAIN_STEPS steps, counts around the fit
    (``compiled``: the first period eager, one capture, then a replay a
    period; launches reckoned by ``run_launches``): fused AdamW one
    launch a leaf a step.  Per period: its wall time and the span from its
    first phase mark to its last (the history rows' ``grads_s`` +
    ``optimizer_s`` + ``sync_s``), whose ratio bounds the device's busy
    share from above (idle gaps inside the span count as busy)."""
    model, phase = spec.model, spec.phase
    cfg = model.cfg
    torch.cuda.reset_peak_memory_stats()
    sess = Session(train_job(algo, exec_, cfg.name), model=model,
                   device="cuda")
    plan = sess.plan
    n_leaves = len(tree_leaves(sess.state.params))   # builds the state
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
    flops = spec.flops_fn(model)
    periods = TRAIN_STEPS // TRAIN_H
    period_marked = [
        sum(h["grads_s"] + h["optimizer_s"] + h["sync_s"]
            for h in sess.history[p * TRAIN_H:(p + 1) * TRAIN_H])
        for p in range(periods)]
    if counts["fused_adamw"] != n_leaves * TRAIN_STEPS:
        raise RuntimeError(f"{phase} {algo} {exec_}: fused_adamw launched "
                           f"{counts['fused_adamw']} times, want "
                           f"{n_leaves * TRAIN_STEPS}")
    # every AdamW launch took the clip's scale and read g as it is, after
    # one norm pass a step (wrapper counts, captured launches included)
    if fused_adamw.scaled_launches != fused_adamw.launches \
            or counts["clip_scale"] != TRAIN_STEPS:
        raise RuntimeError(f"{phase} {algo} {exec_}: {counts['clip_scale']} "
                           f"norm passes in {TRAIN_STEPS} steps, "
                           f"{fused_adamw.scaled_launches} of "
                           f"{fused_adamw.launches} AdamW launches scaled")
    if (algo == "dreamddp-int8") != (counts["quantize_rows"] > 0
                                     and counts["dequantize_rows"] > 0):
        raise RuntimeError(f"{phase} {algo} {exec_}: int8 launches "
                           f"{counts}")
    if (stats.graphs, stats.replays[()]) != (
            (1, periods - 1) if exec_ == "compiled" else (0, 0)):
        raise RuntimeError(f"{phase} {algo} {exec_}: {stats.graphs} graphs, "
                           f"{stats.replays} replays")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise RuntimeError(f"{phase} {algo} {exec_}: losses {losses}")
    result = {
        "phase": phase, "algo": algo, "period_exec": exec_,
        "arch": cfg.name,
        "layers": cfg.n_layers, "d_model": cfg.d_model,
        "reduced": spec.reduced,
        "dtype": cfg.param_dtype, "workers": TRAIN_WORKERS,
        "H": TRAIN_H, "batch_per_worker": TRAIN_B, "seq": TRAIN_S,
        "params_per_replica": model.param_count(), "leaves": n_leaves,
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
        "period_event_ms": [t * 1e3 for t in period_marked],
        "event_span_share": [e / t for e, t in zip(
            period_marked, runner.period_times, strict=True)],
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


def train_profile(sess, unprofiled_ms: float,
                  phase: str = "train_profile") -> dict:
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
        "phase": phase, "algo": sess.cfg.algo,
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
# mamba2_reference's fits (each held to its TRAIN_REF_TOL), and the steps
# of its compiled run (H = 2: an eager period, a capture, two replays)
MAMBA_FIT_ALGOS = ("dreamddp", "dreamddp-int8")
MAMBA_COMPILED_STEPS = 6
# why no SSD launch is counted on the training path
MAMBA_TRAIN_SSD = ("not on this path: the training forward runs the SSD "
                   "einsum path (the chunk kernel has no backward in "
                   "either package); mamba2_reference and mamba2_serve "
                   "launch it")


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
    out = {"phase": "mamba2_reference", "requests": len(comps),
           "tokens": sum(len(c.tokens) for c in comps), "match": True,
           "max_abs_logit_err": err, "logit_tol": MAMBA_REF_TOL,
           "ssd_launches": ssd_chunk_grouped.launches}
    ssd_chunk_grouped.launches = 0
    out["fit"] = {algo: smoke_fit("mamba2-780m", algo, params, cpu_params,
                                  "mamba2_reference")
                  for algo in MAMBA_FIT_ALGOS}
    out["compiled"] = mamba2_compiled(params)
    if ssd_chunk_grouped.launches:
        raise RuntimeError(f"mamba2 training launched the SSD chunk kernel "
                           f"{ssd_chunk_grouped.launches} times")
    out["fit_ssd_chunk_fwd"] = MAMBA_TRAIN_SSD
    return out


def mamba2_compiled(params) -> dict:
    """mamba2 SMOKE's ``dreamddp`` job (2 workers, H = 2) on the card for
    ``MAMBA_COMPILED_STEPS`` steps from ``params``, the pipeline run
    first, then :func:`compiled_reference`: the compiled run **bitwise**
    the pipeline's, one capture, then replays, and a restart bitwise."""
    job = JobConfig(arch="mamba2-780m", smoke=True, algo="dreamddp",
                    workers=2, period=2, seq=32, batch_per_worker=2)
    card = Session(job, params=params, device="cuda")
    init = [x.clone() for x in tree_leaves(card.state.params)]
    card.fit(MAMBA_COMPILED_STEPS)
    return compiled_reference(job, card, init, steps=MAMBA_COMPILED_STEPS)


def mamba2_train_flops(model: Mamba2LM) -> float:
    """One step of every worker: 3 x the forward FLOPs of
    ``Mamba2LM.layer_costs`` (the projections and the head at 2 N a
    token, the SSD's chunk and state products; forward and backward);
    remat's recomputation is not counted."""
    costs = model.layer_costs(TRAIN_WORKERS * TRAIN_B, TRAIN_S)
    return 3.0 * sum(f for _, _, f in costs)


MAMBA2_TRAIN = TrainSpec(Mamba2LM(mamba2_780m.CONFIG), mamba2_train_flops,
                         {"workers": "8 -> 4"}, "mamba2_train")


def mamba2_train(exec_: str, *, keep: bool = False):
    """mamba2-780m at published widths and full depth (48 layers, d_model
    1536, 48 heads x 64, state 128, chunk 128, bf16) through
    :func:`train`: TRAIN_WORKERS workers, H = TRAIN_H, TRAIN_B x TRAIN_S
    tokens a worker, TRAIN_STEPS steps of ``dreamddp``; no SSD chunk
    launch (the training forward is the einsum path)."""
    ssd_chunk_grouped.launches = 0
    result, sess = train("dreamddp", exec_, keep=keep, spec=MAMBA2_TRAIN)
    if ssd_chunk_grouped.launches:
        raise RuntimeError(f"mamba2_train launched the SSD chunk kernel "
                           f"{ssd_chunk_grouped.launches} times")
    cfg = MAMBA2_TRAIN.model.cfg
    result.update({"heads": cfg.n_heads, "head_dim": cfg.head_dim,
                   "d_state": cfg.d_state, "chunk": cfg.chunk,
                   "vocab": cfg.vocab, "depth_cuts": [],
                   "ssd_chunk_fwd": MAMBA_TRAIN_SSD})
    return result, sess


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
                  backends=("paged", "contiguous"), *,
                  frontend: str | None = None, extra_shape=None,
                  max_seq: int = 32) -> dict:
    """Greedy streams of the engine on each of ``backends`` (graphs on
    the card), card against CPU: equal.  With ``frontend``, each request
    brings one seeded ``extra_shape`` input.  Returns tokens by
    backend."""
    prompts = [rng.integers(0, model.cfg.vocab, n).tolist()
               for n in (5, 9, 9, 14, 3, 20)]
    budgets = (6, 4, 8, 3, 7, 5)
    extras = [(rng.standard_normal(extra_shape).astype(np.float32),)
              if frontend else () for _ in prompts]
    streams = {}
    for backend in backends:
        cfg = EngineConfig(max_batch=4, max_seq=max_seq, decode_block=4,
                           kv_backend=backend, page_size=8)
        reqs = [Request(tokens=p, max_new_tokens=g, extra=e)
                for p, g, e in zip(prompts, budgets, extras, strict=True)]
        got = ServeEngine(model, params, cfg, device="cuda",
                          frontend=frontend).generate(reqs)
        want = ServeEngine(model, cpu_params, cfg, device="cpu",
                           frontend=frontend).generate(
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
    params = full_params(model, MOE_PARAMS, "moe_serve")
    result = serve(model, params, SERVE_ENGINE, phase="moe_serve")
    # every expert is read a tick (the dense dispatch runs each expert on
    # its capacity slots): they are in serve()'s bound
    expert_bytes = sum(_nbytes(params["blocks"]["mlp"][k])
                       for k in ("gate", "up", "down"))
    result.update({
        "experts": model.cfg.moe.n_experts, "top_k": model.cfg.moe.top_k,
        "tick_expert_bytes": expert_bytes,
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
    cost = paged_cost(args[0], args[1], table,
                      tokens=int(np.minimum(kv_len, window).sum()))
    nbytes, flops = cost.nbytes, cost.flops
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


# ---------------------------------------------------------------- frontends

# whisper-medium at published widths and full depth: 24 encoder + 24
# decoder layers, d_model 1024, 16 heads of width 64 (g 1), 1500 frames;
# llava-next-34b: 60 layers, d_model 7168, 56/8 heads of width 128 (g
# 7), a 576-patch prefix (one base tile); bf16
WHISPER_PARAMS = 792_032_256
LLAVA_PARAMS = 34_388_917_248
WHISPER_HEADS = {"n_q": 16, "n_kv": 16, "hd": 64}
LLAVA_HEADS = {"n_q": 56, "n_kv": 8, "hd": 128}
LLAVA_PATCHES = 576
# whisper_serve's prompts (pairs of one length: admission groups of 2;
# the published decoder stops at 448 positions) and engine: contiguous
# lanes 448 deep, 8 slots, decode blocks of 8
WHISPER_LENS = (16, 16, 48, 48, 96, 128, 128, 192, 256, 256, 320, 400)
WHISPER_ENGINE = EngineConfig(max_batch=8, max_seq=448, decode_block=8)
# llava_serve: the serve phase's text prompts after 576 patches, paged in
# pages of 16 (70 pages a lane: 576 + 512 + 32 positions)
LLAVA_ENGINE = EngineConfig(max_batch=8, max_seq=1120, decode_block=8,
                            kv_backend="paged", page_size=16)
# whisper_reference / llava_reference, card (kernels) against CPU (plain
# versions), float32 smoke: within atol + rtol * |cpu|
FRONTEND_REF_TOL = (1e-4, 1e-4)


def flash_xcase(dtype, *, b, sq, sk, causal, seed=1, n_q=16, n_kv=16,
                hd=64):
    """Prefill attention of ``sq`` queries over ``sk`` keys from position
    0, causal (``sq == sk``) or not: Whisper's encoder (1500 frames over
    themselves), its cross prefill (a prompt over the frames) and its
    decoder's self prefill."""
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)) \
            .to("cuda", dtype)

    q, k, v = rand(b, sq, n_q, hd), rand(b, sk, n_kv, hd), rand(b, sk, n_kv,
                                                                  hd)
    cost = flash_cost(q, k, v, causal=causal)
    nbytes, flops = cost.nbytes, cost.flops
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def library():
        # yardstick only: the port never calls it
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)

    shape = (f"b {b}, sq {sq}, sk {sk}, {n_q}/{n_kv} heads, hd {hd}, "
             + ("causal" if causal else "non-causal"))
    return (q, k, v), {"causal": causal}, nbytes, flops, library, shape


def lane_case(dtype, *, depth, max_len, lanes=8, seed=5, n_q=16, n_kv=16,
              hd=64):
    """Decode over ``lanes`` contiguous lanes of ``depth`` keys seen as
    pages, as ``WhisperModel.decode_step`` reads its cross and self lanes
    (``WhisperModel.lane_table``, pages of ``lane_page(depth)``).  kv_len
    ragged up to ``max_len`` (the first lane at 1, reading page 0; the
    last at ``max_len``), or ``max_len`` for every lane when ``max_len ==
    depth`` (the cross lanes)."""
    from repro_torch.models.whisper import WhisperModel
    model = WhisperModel(whisper_medium.CONFIG)
    rng = np.random.default_rng(seed)
    if max_len == depth:
        kv_len = np.full(lanes, max_len)
    else:
        kv_len = rng.integers(1, max_len + 1, size=lanes)
        kv_len[0], kv_len[-1] = 1, max_len
    dev = "cuda"
    ps = model.lane_page(depth)
    table = model.lane_table(lanes, depth, dev)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)) \
            .to(dev, dtype)

    q = rand(lanes, n_q, hd)
    k_pages = rand(lanes * depth // ps, ps, n_kv, hd)
    v_pages = rand(lanes * depth // ps, ps, n_kv, hd)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    args = (q, k_pages, v_pages, table, lens)
    cost = paged_cost(q, k_pages, table, tokens=int(kv_len.sum()))
    nbytes, flops = cost.nbytes, cost.flops
    # the same lanes, contiguous: [lanes, heads, depth, hd]
    qt = q[:, :, None]
    kt = k_pages.reshape(lanes, depth, n_kv, hd).transpose(1, 2)
    vt = v_pages.reshape(lanes, depth, n_kv, hd).transpose(1, 2)
    mask = None
    if max_len != depth:
        mask = (torch.arange(depth, device=dev)
                < lens[:, None].long())[:, None, None, :]

    def library():
        # yardstick only: the port never calls it
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)

    shape = (f"lanes {lanes}, {n_q}/{n_kv} heads, hd {hd}, lanes of "
             f"{depth} as pages of {ps}, table {table.shape[1]}, kv_len "
             + (f"{max_len}" if max_len == depth else f"<= {max_len}"))
    return args, {}, nbytes, flops, library, shape


WHISPER_CASES = {
    "flash_attention": [
        {"case": flash_xcase, "b": 2, "sq": 1500, "sk": 1500,
         "causal": False, **WHISPER_HEADS},          # the encoder
        {"case": flash_xcase, "b": 2, "sq": 400, "sk": 1500,
         "causal": False, **WHISPER_HEADS},          # cross prefill
        {"case": flash_xcase, "b": 2, "sq": 400, "sk": 400,
         "causal": True, **WHISPER_HEADS},           # decoder self
        {"case": flash_xcase, "b": 8, "sq": 1500, "sk": 1500,
         "causal": False, **WHISPER_HEADS}],
    "paged_attention": [
        {"case": lane_case, "depth": 1500, "max_len": 1500},   # cross
        {"case": lane_case, "depth": 448, "max_len": 431}],    # self
}
LLAVA_CASES = {
    "flash_attention": [{"b": 2, "s": 896, **LLAVA_HEADS},
                        {"b": 1, "s": 1088, **LLAVA_HEADS}],
    "paged_attention": [{"mb": 70, "max_len": 1120, **LLAVA_HEADS}],
}


def _frontend_direct(model, params, toks, feed, extra, device,
                     frontend) -> dict:
    """A frontend smoke model on ``device`` outside the engine: logits of
    the full forward, the loss, a prefill (flash on the card) and
    ``feed.shape[1]`` decode steps (paged on the card: Whisper over its
    lanes, llava over pages scattered from the prefilled lanes)."""
    b, s = toks.shape
    t = torch.from_numpy(toks).long().to(device)
    e = torch.from_numpy(extra).to(device)
    out = {}
    with torch.no_grad():
        if frontend == "audio":
            out["apply"] = model.apply(params, t, e)
            out["loss"] = model.loss(params, {"tokens": t, "labels": t,
                                              "frames": e})
            prefix, depth = 0, s + feed.shape[1]
            lg, cache = model.prefill(params, t, model.init_cache(
                b, depth, device=device), e)
        else:
            out["apply"] = model.apply(params, t, embeds=e)
            out["loss"] = model.loss(params, {"tokens": t, "labels": t,
                                              "embeds": e})
            prefix = e.shape[1]
            depth = prefix + s + feed.shape[1]
            depth += (-depth) % 8
            lg, cache = model.prefill(params, t, model.init_cache(
                b, depth, device=device), embeds=e)
            pages, bt = _paged_from_lanes(model, cache, 8)
            active = torch.ones(b, dtype=torch.bool, device=device)
        steps = [lg]
        for i in range(feed.shape[1]):
            tok = torch.from_numpy(feed[:, i:i + 1]).long().to(device)
            pos = torch.full((b,), prefix + s + i, dtype=torch.int32,
                             device=device)
            if frontend == "audio":
                lg, cache = model.decode_step(params, cache, tok, pos)
            else:
                lg, pages = model.decode_step_paged(params, pages, tok, pos,
                                                    bt, active)
            steps.append(lg)
        out["prefill_decode"] = torch.cat(steps, 1)
    return {k: v.float().cpu() for k, v in out.items()}


def frontend_reference(phase: str, model, frontend: str, extra_len: int,
                       backends, seed: int) -> dict:
    """A frontend's smoke config (float32) on the card (the flash and
    paged kernels, decode blocks as graph replays) against the CPU
    (plain versions), same weights: logits of the forward, of a prefill
    and of 6 decode steps and the loss within ``FRONTEND_REF_TOL``, both
    kernels launched; the engine's greedy streams on ``backends`` equal,
    each request with its own seeded extra input."""
    cpu_params = model.init(torch.Generator().manual_seed(0))
    params = _to(cpu_params, "cuda")
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (3, 13)).astype(np.int64)
    feed = rng.integers(0, cfg.vocab, (3, 6)).astype(np.int64)
    extra = rng.standard_normal((3, extra_len, cfg.d_model)).astype(
        np.float32)
    f0, p0 = flash_attention.launches, paged_attention.launches
    card = _frontend_direct(model, params, toks, feed, extra, "cuda",
                            frontend)
    launched = {"flash_attention": flash_attention.launches - f0,
                "paged_attention": paged_attention.launches - p0}
    if min(launched.values()) <= 0:
        raise RuntimeError(f"{phase} did not go through both kernels: "
                           f"{launched}")
    cpu = _frontend_direct(model, cpu_params, toks, feed, extra, "cpu",
                           frontend)
    out = {"phase": phase, "logit_tol": FRONTEND_REF_TOL,
           "frontend": frontend, "extra_len": extra_len,
           "prefill_len": toks.shape[1], "decode_steps": feed.shape[1],
           "kernel_launches": launched}
    for key in card:
        err, excess = _max_excess(card[key], cpu[key], FRONTEND_REF_TOL)
        if excess > 0 or not torch.isfinite(card[key]).all():
            raise RuntimeError(f"{phase} {key}: differs by {err}")
        out[f"max_abs_err_{key}"] = err
    prefix = extra_len if frontend == "vision" else 0
    out["stream_tokens_equal"] = smoke_streams(
        model, params, cpu_params, phase, rng, backends, frontend=frontend,
        extra_shape=(extra_len, cfg.d_model),
        max_seq=32 + prefix + (-prefix) % 8)
    del params, cpu_params
    _free()
    return out


def frontend_requests(lens, seed: int, extra_shape):
    """``make_requests`` of a frontend's serve phase: the serve phase's
    requests over ``lens``, each with seeded random float32 extras of
    ``extra_shape`` (the same draws on every call)."""
    def make(vocab, eos_req=None, eos_id=None):
        reqs = serve_requests(vocab, eos_req, eos_id, lens=lens, seed=seed)
        rng = np.random.default_rng(seed + 100)
        return [dataclasses.replace(r, extra=(rng.standard_normal(
            extra_shape, dtype=np.float32),)) for r in reqs]
    return make


def decode_positions(comps, prefix: int = 0):
    """The positions every request decoded at, from its completion: a
    request of prompt length L emitting n tokens decodes at ``prefix + L
    .. prefix + L + n - 2``."""
    return [pos for c in comps
            for pos in range(prefix + c.n_prompt,
                             prefix + c.n_prompt + len(c.tokens) - 1)]


def whisper_serve() -> tuple[dict, dict]:
    """whisper-medium at published widths and full depth, random bf16
    weights: 12 requests of ``WHISPER_LENS`` with seeded frames [1500,
    1024] on the contiguous engine (8 slots, lanes of 448, decode block
    8, graphs): flash 72 launches a prefill call (24 encoder, 24 x 2
    decoder), paged 48 x ``decode_block`` a replay (self and cross);
    then its decode blocks under the profiler.  Returns (serve result,
    profile)."""
    from repro_torch.models.whisper import WhisperModel
    model = WhisperModel(whisper_medium.CONFIG)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    n = count_params(params)
    if not n == model.param_count() == WHISPER_PARAMS:
        raise RuntimeError(f"whisper parameters: {n}, the config counts "
                           f"{model.param_count()}, want {WHISPER_PARAMS}")
    cfg = model.cfg
    make = frontend_requests(WHISPER_LENS, 8, (cfg.n_frames, cfg.d_model))
    kernels = {"flash_attention": flash_attention,
               "paged_attention": paged_attention}
    common, engine, launches = drive_serve(model, params, WHISPER_ENGINE,
                                           make, kernels, frontend="audio")
    per_replay = 2 * cfg.n_dec_layers * WHISPER_ENGINE.decode_block
    per_prefill = cfg.n_enc_layers + 2 * cfg.n_dec_layers
    held = engine.block_stats.captured_launches
    if common["graphs_captured"] != 2 or engine._attn_scratch is None \
            or any(h != {"paged_attention": per_replay}
                   for h in held.values()) \
            or common["eager_launches"]["paged_attention"] != 0 \
            or launches["paged_attention"] != per_replay * common["replays"] \
            or launches["flash_attention"] != \
            per_prefill * common["prefill_batches"]:
        raise RuntimeError(
            f"whisper_serve launches {launches} ({common['eager_launches']} "
            f"eager) over {common['replays']} replays of graphs holding "
            f"{held} and {common['prefill_batches']} prefill calls; want "
            f"paged {per_replay} a replay, flash {per_prefill} a prefill")
    # what a tick must read: the decoder's weights, the tied table whole
    # (as the head), and the live lanes' cross K/V (every frame) and
    # self K/V (pos + 1 keys), their mean over the run's ticks
    comps = engine.take_completed()
    es = torch.tensor([], dtype=cfg.dtype).element_size()
    # (not the cross projections wk and wv: cross K/V was cached at
    # prefill, and decode never reads them)
    cross = params["dec_blocks"]["cross_attn"]
    weight_bytes = sum(_nbytes(t) for t in tree_leaves(params["dec_blocks"])) \
        - sum(_nbytes(t) for t in tree_leaves({"wk": cross["wk"], "wv": cross["wv"]})) \
        + _nbytes(params["embed"]["table"]) \
        + sum(_nbytes(t) for t in tree_leaves(params["head"]))
    per_key = 2 * cfg.d_model * es * cfg.n_dec_layers
    positions = decode_positions(comps)
    cross_read = per_key * cfg.n_frames * len(positions) / common["ticks_run"]
    self_read = per_key * sum(p + 1 for p in positions) / common["ticks_run"]
    bound_ms = (weight_bytes + cross_read + self_read) / HBM_BYTES_PER_S * 1e3
    arena = engine.pool.arena
    cross_bytes = _nbytes(arena["cross_k"]) + _nbytes(arena["cross_v"])
    result = {
        "phase": "whisper_serve", **common, "backend": "contiguous",
        "frames": cfg.n_frames, "heads": cfg.n_heads, "head_dim": cfg.hd,
        "enc_layers": cfg.n_enc_layers, "dec_layers": cfg.n_dec_layers,
        "prompt_lens": list(WHISPER_LENS),
        "max_seq": WHISPER_ENGINE.max_seq,
        "cross_kv_bytes": cross_bytes,
        "self_kv_bytes": engine.pool.kv_bytes() - cross_bytes,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
        "tick_weight_bytes": weight_bytes,
        "tick_cross_read_bytes_mean": cross_read,
        "tick_self_read_bytes_mean": self_read,
        "bound_ms_per_tick": bound_ms,
        "share_of_bound": bound_ms / common["ms_per_decode_tick"],
    }
    del engine
    _free()
    profile = profile_decode(model, params, WHISPER_ENGINE,
                             make(cfg.vocab), "whisper_profile",
                             frontend="audio")
    del model, params
    _free()
    return result, profile


def llava_serve() -> tuple[dict, dict]:
    """llava-next-34b at published widths and full depth, random bf16
    weights (68.78 GB, drawn on the card a leaf slice at a time): 12
    requests of the serve phase's text lengths after seeded patch
    embeddings [576, 7168], paged in pages of 16 (8 slots, 70 pages a
    lane, decode block 8, graphs): flash 60 launches a prefill call,
    paged 60 x ``decode_block`` a replay; then its decode blocks under
    the profiler.  Returns (serve result, profile)."""
    _free()
    model = DecoderLM(llava_next_34b.CONFIG)
    params = full_params(model, LLAVA_PARAMS, "llava_serve")
    cfg = model.cfg
    make = frontend_requests(SERVE_LENS, 9, (LLAVA_PATCHES, cfg.d_model))
    result = serve(model, params, LLAVA_ENGINE, "llava_serve",
                   make_requests=make, frontend="vision",
                   prefix=LLAVA_PATCHES)
    result.update({"patches": LLAVA_PATCHES,
                   "prompt_lens": list(SERVE_LENS), "depth_cuts": []})
    _free()
    profile = profile_decode(model, params, LLAVA_ENGINE, make(cfg.vocab),
                             "llava_profile", frontend="vision")
    del model, params
    _free()
    return result, profile


# ---------------------------------------------------------- dense configs

# the dense configs served at published widths and full depth, in the
# order they run (qwen2.5-32b last: its 65.5 GB of weights want the card
# to themselves): (phase, config module, parameters, the reference
# phase's seed)
DENSE_SERVES = (("qwen3_serve", qwen3_1_7b, 1_720_574_976, 17),
                ("phi4_serve", phi4_mini_3_8b, 3_836_021_760, 18),
                ("qwen25_serve", qwen2_5_32b, 32_763_876_352, 19))


def dense_cases(cfg) -> dict:
    """The attention kernels at a dense config's serve geometry
    (SERVE_ENGINE's max_seq 544 and admission groups of b <= 2, prompts
    up to 512): its heads (GQA group 2, 3 or 5) at its head width."""
    heads = {"n_q": cfg.n_heads, "n_kv": cfg.n_kv_heads, "hd": cfg.hd}
    return {"flash_attention": [{"b": 2, "s": 256, **heads},
                                {"b": 1, "s": 512, **heads}],
            "paged_attention": [{"mb": 34, "max_len": 544, **heads}]}


def dense_reference(phase: str, module, seed: int) -> dict:
    """A dense config's SMOKE (float32: qwen3's ``qk_norm``, qwen2.5's QKV
    bias, phi4's GQA group 3) on the card (flash prefill, paged decode,
    decode blocks as graph replays) against the CPU (plain versions),
    same weights: :func:`smoke_direct` through both kernels, within
    ``MOE_REF_TOL``, and :func:`smoke_streams` on the paged and
    contiguous backends, equal."""
    model = DecoderLM(module.SMOKE)
    cpu_params = model.init(torch.Generator().manual_seed(0))
    params = _to(cpu_params, "cuda")
    f0, p0 = flash_attention.launches, paged_attention.launches
    out, rng = smoke_direct(model, params, cpu_params, phase, seed)
    launched = {"flash_attention": flash_attention.launches - f0,
                "paged_attention": paged_attention.launches - p0}
    if min(launched.values()) <= 0:
        raise RuntimeError(f"{phase} did not go through both kernels: "
                           f"{launched}")
    cfg = model.cfg
    out.update({"arch": module.CONFIG.name, "smoke": cfg.name,
                "heads": f"{cfg.n_heads}/{cfg.n_kv_heads}",
                "qkv_bias": cfg.qkv_bias, "qk_norm": cfg.qk_norm,
                "tied": cfg.tie_embeddings, "kernel_launches": launched})
    out["stream_tokens_equal"] = smoke_streams(model, params, cpu_params,
                                               phase, rng)
    del params, cpu_params
    _free()
    return out


def dense_serve(phase: str, module, n_params: int) -> tuple[dict, dict]:
    """A dense config at published widths and full depth, random bf16
    weights drawn on the card after every earlier phase's memory is
    freed: :func:`serve` with the serve phase's 12 requests and engine
    (paged, 8 slots, decode block 8, graphs), its launch checks and its
    tick's byte bound; then its decode blocks under the profiler.
    Returns (serve result, profile)."""
    _free()
    model = DecoderLM(module.CONFIG)
    params = full_params(model, n_params, phase)
    cfg = model.cfg
    result = serve(model, params, SERVE_ENGINE, phase=phase)
    result.update({
        "gqa_group": cfg.n_heads // cfg.n_kv_heads,
        "qkv_bias": cfg.qkv_bias, "qk_norm": cfg.qk_norm,
        "tied": cfg.tie_embeddings, "vocab": cfg.vocab,
        "prompt_lens": list(SERVE_LENS), "depth_cuts": [],
    })
    profile = profile_decode(model, params, SERVE_ENGINE,
                             phase=phase.replace("_serve", "_profile"))
    del model, params
    _free()
    return result, profile


# ---------------------------------------------------------- grouped GEMM

# moonlight-train-dreamddp's held expert layer: T k = 8192 x 6 rows a
# worker step, 8 held experts, gate+up (K 2048, N 2 x 1408) and down
# (K 1408, N 2048)
GROUPED_ROWS, GROUPED_G = 8192 * 6, 8
GROUPED_SHAPES = (("gate_up", 2048, 2816), ("down", 1408, 2048))
GROUPED_KINDS = ("routed", "empty", "all_in_one")


def grouped_offsets(kind: str, M: int, G: int, gen) -> torch.Tensor:
    """Offsets ``[G + 1]`` int32 on the card: ~``M / (8 G)`` rows a group
    (an eighth of the pairs held, as in the cell), the same with groups
    0, 3 and ``G - 1`` empty, or one group holding all ``M`` rows."""
    if kind == "all_in_one":
        counts = [0] * G
        counts[G // 2] = M
    else:
        counts = torch.randint(M // (10 * G), M // (6 * G), (G,),
                               generator=gen).tolist()
        if kind == "empty":
            counts[0] = counts[3] = counts[G - 1] = 0
    offs = [0]
    for c in counts:
        offs.append(offs[-1] + c)
    return torch.tensor(offs, dtype=torch.int32, device="cuda")


def _grouped_library(layout: str, a, b, offs, end: int):
    """``torch._grouped_mm`` over the routed rows, or None where the
    card's torch lacks it."""
    lib = getattr(torch, "_grouped_mm", None)
    if lib is None:
        return None
    ends = offs[1:]
    if layout == "fwd":
        x = a[:end]
        return lambda: lib(x, b, offs=ends)
    if layout == "dgrad":
        x, wt = a[:end], b.transpose(1, 2)
        return lambda: lib(x, wt, offs=ends)
    xt, dy = a[:end].t(), b[:end]
    return lambda: lib(xt, dy, offs=ends)


def check_grouped_gemm() -> dict:
    """Phase 33's kernel checks: every shape x layout x kind, the first
    (gate+up forward, rows routed) the kernels line's row."""
    gen = torch.Generator().manual_seed(31)
    M, G = GROUPED_ROWS, GROUPED_G
    atol, rtol = TOL[torch.bfloat16]
    checks = []
    for kind in GROUPED_KINDS:
        offs = grouped_offsets(kind, M, G, gen)
        end = int(offs[-1])
        for name, K, N in GROUPED_SHAPES:
            x = torch.randn(M, K, generator=gen).to("cuda", torch.bfloat16)
            w = (torch.randn(G, K, N, generator=gen) * 0.02).to(
                "cuda", torch.bfloat16)
            dy = torch.randn(M, N, generator=gen).to("cuda", torch.bfloat16)
            for layout, a, b in (("fwd", x, w), ("dgrad", dy, w),
                                 ("wgrad", x, dy)):
                got = grouped_gemm(a, b, offs, layout, impl="cuda")
                want32 = grouped_gemm_ref(a.float(), b.float(), offs,
                                          layout)
                what = f"grouped_gemm {name} {layout} {kind}"
                if got.dtype != torch.bfloat16 \
                        or got.shape != want32.shape \
                        or not torch.isfinite(got.float()).all():
                    raise RuntimeError(f"{what}: output {got.dtype} "
                                       f"{tuple(got.shape)} or non-finite")
                # float32 sums over n terms (K, N, or a group's rows in
                # wgrad) differ by order by ~sqrt(n) 2^-24 of the sum of
                # the terms' sizes (``mag``); 16x that, beside TOL's room
                # for the bf16 output: a wrong tile is off by |want|
                n = max(int(offs[g + 1] - offs[g]) for g in range(G)) \
                    if layout == "wgrad" else a.shape[1]
                mag = grouped_gemm_ref(a.float().abs(), b.float().abs(),
                                       offs, layout)
                sum_tol = 16 * math.sqrt(n) * 2.0 ** -24
                diff = (got.float() - want32).abs()
                room = atol + rtol * want32.abs() + sum_tol * mag
                worst = int((diff - room).argmax())
                excess = float((diff - room).view(-1)[worst])
                err = diff.max().item()
                if excess > 0:
                    at = [float(t.view(-1)[worst]) for t in
                          (got.float(), want32, mag)]
                    raise RuntimeError(
                        f"{what}: max abs err {err}; beyond atol {atol} + "
                        f"rtol {rtol} + {sum_tol:.3g} x sum of |terms| at "
                        f"got {at[0]}, want {at[1]}, sum of |terms| {at[2]}")
                del mag, room
                if layout != "wgrad" and got[end:].any():
                    raise RuntimeError(f"{what}: rows past the last group "
                                       "are not zero")
                empty = [g for g in range(G) if offs[g] == offs[g + 1]]
                if layout == "wgrad" and any(got[g].any() for g in empty):
                    raise RuntimeError(f"{what}: an empty group's dW is "
                                       "not zero")
                del got, want32, diff
                cost = grouped_cost(end, G, K, N)
                b_ms, b_by = bound(cost.nbytes,
                                   (cost.flops, torch.bfloat16))
                ms = median_ms(lambda: grouped_gemm(a, b, offs, layout,
                                                    impl="cuda"))
                library = _grouped_library(layout, a, b, offs, end)
                try:
                    library_ms = median_ms(library) if library else None
                except RuntimeError as e:
                    library_ms = f"refused: {str(e)[:160]}"
                row = {
                    "shape": f"{name}: M {M}, G {G}, K {K}, N {N}, rows "
                             f"{end} ({kind})",
                    "layout": layout, "dtype": "bfloat16", "rows": end,
                    "empty_groups": len(empty),
                    "max_abs_err": err, "atol": atol, "rtol": rtol,
                    "sum_tol": sum_tol, "ms": ms,
                    "plain_ms": median_ms(
                        lambda: grouped_gemm_ref(a, b, offs, layout),
                        reps=5, hold=False),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "share_of_bound": b_ms / ms,
                    "library_ms": library_ms,
                    "bytes": cost.nbytes, "flops": cost.flops,
                }
                emit({"phase": "kernel", "name": "grouped_gemm", **row})
                checks.append(row)
            del x, w, dy
        _free()
    return {"name": "grouped_gemm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/grouped_gemm.cu",
            "replaces": "src/repro/models/moe.py:99 (capacity einsums: no "
                        "TPU kernel; the port's dropless layer)",
            "checks": checks}


def moonlight_train() -> dict:
    """Phase 33's path: Moonlight's smoke model (1 dense + 2 MoE layers,
    8 experts, top-2) in bfloat16, ``dreamddp`` through the compiled
    runner, 2 workers x 2 x 16 tokens, H = 2, three periods (the first
    eager, then one capture and two replays).  ``grouped_gemm.launches``
    is set to 0 just before the fit; the run's launches are the wrapper's
    count less the capture's, plus the replays x what the graph holds."""
    cfg = dataclasses.replace(moonlight_16b_a3b.SMOKE,
                              param_dtype="bfloat16")
    model = DecoderLM(cfg)
    W, H, b, s, steps = 2, 2, 2, 16, 6
    sess = Session(JobConfig(arch="moonlight-16b-a3b", smoke=True,
                             algo="dreamddp", workers=W, period=H, seq=s,
                             batch_per_worker=b, period_exec="compiled"),
                   model=model, device="cuda")
    sess.state
    grouped_gemm.launches = 0
    t0 = time.perf_counter()
    sess.fit(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = sess.runner.graph_stats
    held = stats.captured_launches.get((), {}).get("grouped_gemm", 0)
    launches = grouped_gemm.launches + (stats.replays[()] - 1) * held
    n_moe = cfg.n_layers - cfg.n_dense_layers
    want = 8 * n_moe * W * steps
    routed = int(model.routed_rows.total.sum())
    pairs = steps * W * b * s * cfg.moe.top_k * n_moe
    losses = [h["loss"] for h in sess.history]
    if stats.graphs != 1 or stats.replays[()] != steps // H - 1 \
            or launches != want or routed != pairs \
            or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"moonlight_train: {stats.graphs} graphs, "
                           f"{dict(stats.replays)} replays, grouped_gemm "
                           f"launches {launches} (want {want}), routed "
                           f"rows {routed} (want {pairs}), losses {losses}")
    out = {"phase": "moonlight_train", "steps": steps, "workers": W,
           "moe_layers": n_moe, "graphs": stats.graphs,
           "replays": stats.replays[()],
           "grouped_gemm_per_replay": held,
           "launches": {"grouped_gemm": launches},
           "routed_rows": routed, "losses": losses, "wall_s": wall}
    del sess, model
    _free()
    return out


# ---------------------------------------------------------------- dry run

# production cells the dry run traces on meta tensors within the time
# limit (arch, shape, multi_pod)
DRYRUN_CELLS = (("granite-3-2b", "train_4k", False),
                ("mamba2-780m", "train_4k", False),
                ("qwen3-moe-30b-a3b", "decode_32k", True),
                ("deepseek-v3-671b", "prefill_32k", False))
# granite-3-2b's cells on one card, built by the dry run's own builders:
# full width and depth to serve, 8 layers as one worker (large) to train
CARD_MESH = MeshSpec((1, 1), ("data", "model"))
CARD_CELLS = (
    ("decode", granite_3_2b.ARCH, ShapeSpec("card_decode", 4096, 8,
                                            "decode")),
    ("prefill", granite_3_2b.ARCH, ShapeSpec("card_prefill", 2048, 4,
                                             "prefill")),
    ("train", dataclasses.replace(granite_3_2b.ARCH, large=True,
                                  make_model=lambda: DecoderLM(TRAIN_MODEL)),
     ShapeSpec("card_train", 512, 4, "train")))
ARG_BYTES_RTOL = 0.01        # predicted against allocated argument bytes
DRYRUN_KERNELS = (flash_attention, paged_attention, ssd_chunk_grouped,
                  fused_adamw, quantize_rows, dequantize_rows)


def dryrun_production(out_dir: Path) -> list[dict]:
    """``launch.dryrun.run_cell`` on each of ``DRYRUN_CELLS``: per-device
    FLOPs, memory and wire bytes, the H100 roofline's three terms and the
    dominant one (reckoned from data-sheet constants, not measured)."""
    rows = []
    for arch_id, shape_name, multi_pod in DRYRUN_CELLS:
        art = run_cell(arch_id, shape_name, multi_pod=multi_pod,
                       out_dir=str(out_dir), verbose=False)
        n, r = art["n_devices"], art["roofline_h100"]
        row = {"phase": "dryrun", "cell": f"{arch_id} {shape_name} "
                                          f"{art['mesh']}",
               "flops_per_device": art["cost_analysis"]["flops"] / n,
               "mem_per_device_gb":
                   art["memory_analysis"]["total_bytes"] / 1e9,
               "wire_per_device_gb":
                   art["collectives"]["total_wire_bytes"] / 1e9,
               "h100_compute_s": r["compute_s"],
               "h100_memory_s": r["memory_s"],
               "h100_collective_s": r["collective_s"],
               "dominant": r["dominant"],
               "trace_seconds": art["trace_seconds"]}
        emit(row)
        rows.append(row)
    return rows


def dryrun_card(kind: str, arch, shape) -> dict:
    """One dry-run cell held against the card: built by the port's
    ``build_*_cell`` on a one-device mesh and traced on meta tensors,
    then materialized on the card from a seeded generator and its step
    called.  Predicted argument bytes against the allocation they took
    (must agree within ``ARG_BYTES_RTOL``), predicted peak (arguments +
    temporaries) against ``max_memory_allocated`` over one call, the
    roofline time against the call's held median; the kernels' launches
    in that one call (counts set to 0 just before, read just after)."""
    build = {"decode": dry_cells.build_decode_cell,
             "prefill": dry_cells.build_prefill_cell,
             "train": dry_cells.build_train_cell}[kind]
    cell = build(arch, shape, CARD_MESH, multi_pod=False)
    counter, out = cell.trace()
    art = artifact(cell, counter, out, 0.0)
    mem = art["memory_analysis"]
    _free()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    args = cell.materialize(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    arg_bytes = torch.cuda.memory_allocated() - base
    predicted = mem["argument_size_in_bytes"]
    torch.cuda.reset_peak_memory_stats()
    for fn in DRYRUN_KERNELS:
        fn.launches = 0
    out = cell.step(*args)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in DRYRUN_KERNELS
                if fn.launches}
    peak = torch.cuda.max_memory_allocated() - base
    result = out[1]["loss"] if kind == "train" else out[0]
    if not torch.isfinite(result.float()).all():
        raise RuntimeError(f"dryrun {kind}: non-finite output")
    ms = median_ms(lambda: cell.step(*args), reps=10, warmup=2)
    r = art["roofline_h100"]
    roof_s = max(r["compute_s"], r["memory_s"], r["collective_s"])
    row = {"phase": "dryrun_card", "kind": kind, "shape": vars(shape),
           "layers": arch.make_model().cfg.n_layers,
           "arg_bytes_predicted": predicted, "arg_bytes_allocated":
               arg_bytes, "arg_ratio": arg_bytes / predicted,
           "peak_bytes_predicted": predicted + mem["temp_size_in_bytes"],
           "peak_bytes_measured": peak,
           "peak_ratio": peak / (predicted + mem["temp_size_in_bytes"]),
           "flops": art["cost_analysis"]["flops"],
           "bytes": art["cost_analysis"]["bytes accessed"],
           "roofline_ms": roof_s * 1e3, "dominant": r["dominant"],
           "ms": ms, "time_ratio": ms / (roof_s * 1e3),
           "launches": launches, "meta_kernels": art["kernels"]}
    emit(row)
    del args, out, result
    _free()
    if abs(arg_bytes - predicted) > ARG_BYTES_RTOL * predicted:
        raise RuntimeError(f"dryrun {kind}: {arg_bytes} argument bytes "
                           f"allocated, {predicted} predicted")
    return row


def dryrun(out_dir: Path) -> dict:
    """The dry-run phase: the production cells, then the card cells."""
    production = dryrun_production(out_dir)
    card = {kind: dryrun_card(kind, arch, shape)
            for kind, arch, shape in CARD_CELLS}
    if not card["prefill"]["launches"].get("flash_attention") or \
            not card["train"]["launches"].get("fused_adamw"):
        raise RuntimeError("dryrun: the card cells' steps did not run "
                           "flash (prefill) and fused AdamW (train)")
    return {"production": production, "card": card}



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
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    b0 = time.perf_counter()
    seconds = _build.build()
    emit({"phase": "build", "seconds": seconds,
          "wall_s": time.perf_counter() - b0})

    tiny = torch.zeros(16, device="cuda")
    emit({"phase": "timing", "floor_ms": median_ms(lambda: tiny.add_(1)),
          "what": "median_ms of one one-block elementwise kernel: the "
                  "launch and event overhead inside every kernel time"})
    kernels = [check_kernel(k) for k in KERNELS]
    emit(reference_check())
    emit(graph_check())
    emit(sync_check())
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
    emit(check_clip())
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
    result = mamba2_reference()
    emit(result)
    for row in rows:            # the Mamba-2 slice's fits ran the train kernels
        if row["path"] == "train":
            row["launches_mamba2_reference"] = {
                algo: fit["launches"][row["name"]]
                for algo, fit in result["fit"].items()}
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
    for exec_ in ("pipeline", "compiled"):
        result, sess = mamba2_train(exec_, keep=exec_ == "compiled")
        emit(result)
        for row in rows:        # Mamba-2 at width ran fused AdamW
            if row["name"] == "fused_adamw":
                row.setdefault("launches_mamba2_train", {})[exec_] = \
                    result["launches"]["fused_adamw"]
        if sess is not None:
            emit(train_profile(sess, result["ms_per_step"],
                               "mamba2_train_profile"))
            del sess
        _free()

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

    kernels = [check_kernel(k, WHISPER_CASES[k]) for k in WHISPER_CASES]
    from repro_torch.models.whisper import WhisperModel
    emit(frontend_reference("whisper_reference",
                            WhisperModel(whisper_medium.SMOKE), "audio",
                            whisper_medium.SMOKE.n_frames,
                            ("contiguous",), 15))
    result, profile = whisper_serve()
    emit(result)
    emit(profile)
    rows += kernel_rows(kernels, result["launches"], "whisper_serve")

    kernels = [check_kernel(k, LLAVA_CASES[k]) for k in LLAVA_CASES]
    emit(frontend_reference("llava_reference",
                            DecoderLM(llava_next_34b.SMOKE), "vision", 8,
                            ("paged", "contiguous"), 16))
    result, profile = llava_serve()
    emit(result)
    emit(profile)
    rows += kernel_rows(kernels, result["launches"], "llava_serve")

    for phase, module, n_params, seed in DENSE_SERVES:
        cases = dense_cases(module.CONFIG)
        kernels = [check_kernel(k, cases[k]) for k in cases]
        emit(dense_reference(phase.replace("_serve", "_reference"), module,
                             seed))
        result, profile = dense_serve(phase, module, n_params)
        emit(result)
        emit(profile)
        rows += kernel_rows(kernels, result["launches"], phase)

    kernels = [check_grouped_gemm()]
    result = moonlight_train()
    emit(result)
    rows += kernel_rows(kernels, result["launches"], "moonlight_train")

    _free()
    result = dryrun(ROOT / "build" / "dryrun")
    for row in rows:            # the dry run's granite cells ran these
        for kind, card in result["card"].items():
            if row["path"] in ("serve", "train") \
                    and row["name"] in card["launches"]:
                row.setdefault("launches_dryrun", {})[kind] = \
                    card["launches"][row["name"]]

    emit({"phase": "wall", "seconds": time.perf_counter() - t0,
          "what": "the whole script, from main's start to here"})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
