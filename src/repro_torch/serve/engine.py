"""ServeEngine — continuous-batching inference over a slot-pooled cache.

Counterpart of ``repro.serve.engine`` for the decoder LM (dense, MoE
and MLA; both cache backends), Mamba-2 and the Griffin hybrid (the
contiguous backend: their lanes are fixed conv windows and recurrent
states, and Griffin's attention a ring of ``window`` keys, with nothing
to page).
Requests are data (:class:`~repro_torch.serve.types.Request`),
admission is the :class:`~repro_torch.serve.scheduler.Scheduler`'s, and
decoding runs ``decode_block`` slot-wide ticks between scheduler
interventions, with per-slot EOS and length masking.

**The decode block.**  The reference runs a block as one jitted
``lax.while_loop`` that exits once no lane is active.  Here one body
(:meth:`ServeEngine._block_body`) runs all ``decode_block`` ticks over
static buffers (the slot state, the emitted tokens, the tick count, the
block tables and the block's uniforms), updates them in place and reads
nothing back to the host.  A tick after every lane has finished is fully
masked: it emits ``-1`` and freezes the state, as an inactive lane does,
and its cache writes land where an inactive lane's do (the paged pool's
trash page, beyond a contiguous lane's frontier, or a retired Mamba-2
lane's state, which the next prefill rewrites).  The body counts on the
device the ticks at whose start some lane was active, which is the
reference's early-exit count, since no lane turns active within a block;
so ``slot_ticks_total`` and every other counter equal the reference's.
The block's tokens, the lanes' liveness and that count reach the host in
one read.

On CUDA the body's two variants (greedy, and sampled with the block's
uniforms drawn before it) are captured as CUDA graphs when the engine is
built, while no lane is live, and each block is one replay; before it
the host writes only the static inputs.  A capture that fails raises:
the engine runs the body eagerly on CUDA only when built with
``cuda_graphs=False``.  On the CPU the body is called as it is.  What a
graph reads stays at its address for the engine's life: the parameters
(``reset(params=...)`` copies new values into the same tensors), the
pool, the state buffers and the paged kernel's split-K scratch, which
the engine owns (none for MLA, whose paged decode runs no kernel; one
for the Griffin hybrid on the contiguous backend, whose decode runs the
kernel over its rings, from the model's ``decode_scratch``).
:attr:`ServeEngine.block_stats` records the graphs, their capture time,
the kernel launches each graph holds, and the blocks and ticks run.

Admission: with ``batched_admission`` (the default) each tick's
admissions are grouped by prefill bucket, each group prefills in one
slot-batched call, and all first tokens of the tick reach the host in
one read; ``batched_admission=False`` prefills and syncs per request.
Both give the same greedy token streams.  Prefill runs eagerly.

Entry points::

    engine.generate(requests)              # synchronous, list[Completion]
    engine.generate(tokens, 16)            # [B, S] -> [B, 16] token array
    rid = engine.submit(req, on_token=cb)  # incremental / streaming
    while engine.has_work:
        engine.step()                      # one admission + decode block
    engine.drain(); engine.reset(params=p)

Frontends (vision patches, audio frames) are not ported yet.
"""

from __future__ import annotations

import collections
import time
from collections import deque
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.flash_attention import flash_attention
from ..kernels.paged_attention import paged_attention
from ..kernels.paged_attention.ops import launch_scratch
from ..kernels.ssd_scan import ssd_chunk_grouped
from ..runtime.step import slot_decode, slot_decode_paged, slot_prefill
from ..tree import tree_map
from .cache import CachePool, PagedCachePool
from .config import EngineConfig
from .sampling import draw_uniform, make_token_sampler
from .scheduler import RequestState, Scheduler
from .types import Completion, EngineStats, Request, SamplingParams

__all__ = ["ServeEngine", "BlockStats"]

Tree = Any

# the kernel wrappers whose launch counters say what a captured graph holds
_KERNELS = (paged_attention, flash_attention, ssd_chunk_grouped)
_VARIANTS = ("greedy", "sampled")


@dataclass
class _SlotState:
    """Per-slot decode state on the device, all ``[n_slots]``.  ``pos``
    is the next KV write index, ``token`` the last sampled token.  The
    tensors are allocated once and only ever updated in place."""

    token: torch.Tensor
    pos: torch.Tensor
    ngen: torch.Tensor
    active: torch.Tensor
    temp: torch.Tensor
    top_k: torch.Tensor
    eos: torch.Tensor
    max_gen: torch.Tensor

    @classmethod
    def zeros(cls, n_slots: int, device) -> "_SlotState":
        i32 = dict(dtype=torch.int32, device=device)
        return cls(
            token=torch.zeros(n_slots, **i32),
            pos=torch.zeros(n_slots, **i32),
            ngen=torch.zeros(n_slots, **i32),
            active=torch.zeros(n_slots, dtype=torch.bool, device=device),
            temp=torch.zeros(n_slots, dtype=torch.float32, device=device),
            top_k=torch.zeros(n_slots, **i32),
            eos=torch.full((n_slots,), -1, **i32),
            max_gen=torch.zeros(n_slots, **i32))

    def zero_(self) -> None:
        """Back to :meth:`zeros`' values, in place."""
        for name, t in vars(self).items():
            t.fill_(-1 if name == "eos" else 0)


@dataclass
class BlockStats:
    """The decode-block body's record, beside :class:`EngineStats` (which
    keeps the reference's counters).

    ``graphs``: CUDA graphs captured (one per body variant on CUDA, none
    when the body runs as it is); ``capture_s``: seconds spent warming
    up and capturing them (outside
    ``EngineStats.decode_time_s``); ``captured_launches``: per variant,
    the kernel launches its graph holds, by wrapper name, as the
    wrappers' counters moved during the capture; ``blocks``: blocks run
    per variant (graph replays, on CUDA); ``ticks_run``: the ticks of
    those blocks at whose start some lane was active (the reference's
    early-exit counts, summed).  ``blocks`` and ``ticks_run`` restart at
    :meth:`ServeEngine.reset`.
    """

    graphs: int = 0
    capture_s: float = 0.0
    captured_launches: dict[str, dict[str, int]] = field(
        default_factory=dict)
    blocks: collections.Counter = field(default_factory=collections.Counter)
    ticks_run: int = 0

    @property
    def replays(self) -> int:
        return sum(self.blocks.values())

    def masked_ticks(self, decode_block: int) -> int:
        """Ticks run with every lane idle, which the reference's early
        exit skips: blocks x ``decode_block`` - ticks run."""
        return self.replays * decode_block - self.ticks_run

    def kernel_launches(self) -> dict[str, int]:
        """Kernel launches the blocks made through captured graphs, by
        wrapper name: replays x the launches each graph holds.  (The
        wrappers' own counters move during capture, never on replay.)"""
        out: collections.Counter = collections.Counter()
        for variant, n in self.blocks.items():
            for name, k in self.captured_launches.get(variant, {}).items():
                out[name] += n * k
        return dict(out)


class ServeEngine:
    """Continuous-batching generation engine for one model replica.

    ``params`` must already live on ``device`` (the GPU unless
    ``device="cpu"`` is passed).  The engine reads them in place and
    owns them from then on: :meth:`reset` with ``params`` copies new
    values into these same tensors.  ``cuda_graphs`` (default: on for
    CUDA) captures the decode block's variants as CUDA graphs;
    ``cuda_graphs=False`` on CUDA runs the same body eagerly, the
    oracle a graph is held to.  ``keep_logits`` keeps the last block's
    logits, ``[decode_block, n_slots, vocab]``, in :attr:`last_logits`.
    """

    def __init__(self, model, params: Tree,
                 config: EngineConfig | None = None, *, device=None,
                 cuda_graphs: bool | None = None,
                 keep_logits: bool = False):
        self.device = resolve_device(device)
        dev = self.device
        table = params["embed"]["table"]
        if table.device.type != dev.type:
            raise ValueError(f"params live on {table.device}, the engine "
                             f"runs on {dev}")
        if cuda_graphs is None:
            cuda_graphs = dev.type == "cuda"
        if cuda_graphs and dev.type != "cuda":
            raise ValueError("cuda_graphs=True needs a CUDA device")
        self.model = model
        self.params = params
        self.config = config or EngineConfig()
        if self.config.prefill_chunk and \
                not getattr(model, "kv_position_indexed", False):
            raise ValueError(
                "prefill_chunk requires a position-indexed KV cache; "
                f"{type(model).__name__} carries recurrent state that "
                "right-padded prefill would corrupt — use exact prefill "
                "(prefill_chunk=None)")
        self._paged = self.config.kv_backend == "paged"
        if self._paged:
            self.pool: CachePool = PagedCachePool(
                model, self.config.slots, self.config.max_seq,
                page_size=self.config.page_size,
                n_pages=self.config.kv_pages, device=dev)
        else:
            self.pool = CachePool(model, self.config.slots,
                                  self.config.max_seq, device=dev)
        self.scheduler = Scheduler(
            self.pool, max_batch=self.config.max_batch,
            max_prefills_per_tick=self.config.max_prefills_per_tick)
        self._sample = make_token_sampler(model.cfg.vocab)
        # per-slot host generator of a sampling request (None: greedy)
        self._gens: list[torch.Generator | None] = [None] * self.config.slots
        self._stats = EngineStats()
        self._completed: deque[Completion] = deque(
            maxlen=self.config.completed_cap)
        # distinct shapes each prefill-side step ran (compile_stats)
        self._shapes: dict[str, set] = collections.defaultdict(set)

        # the decode block's static buffers (a graph reads and writes
        # these addresses); the outputs share one buffer, which the host
        # reads in one copy: emitted tokens, liveness, ticks run
        n, db = self.config.slots, self.config.decode_block
        self._state = _SlotState.zeros(n, dev)
        self._readback = torch.zeros(db * n + n + 1, dtype=torch.int32,
                                     device=dev)
        self._out = self._readback[:db * n].view(db, n)
        self._live = self._readback[db * n:-1]
        self._iters = self._readback[-1]
        self._u = torch.zeros((db, n), dtype=torch.float32, device=dev)
        self._block_tables = self._attn_scratch = None
        if self._paged:
            self._block_tables = torch.zeros(self.pool.block_tables.shape,
                                             dtype=torch.int32, device=dev)
            cfg = model.cfg
            # MLA's paged decode attends gathered latents, not the kernel
            if dev.type == "cuda" and getattr(cfg, "mla", None) is None:
                self._attn_scratch = launch_scratch(
                    n, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                    self.pool.max_blocks, dev)
        elif dev.type == "cuda" and hasattr(model, "decode_scratch"):
            # a contiguous cache whose decode runs the paged kernel
            self._attn_scratch = model.decode_scratch(n, dev)
        self.last_logits = torch.zeros(
            (db, n, model.cfg.vocab), dtype=table.dtype,
            device=dev) if keep_logits else None

        self.block_stats = BlockStats()
        self._graphs: dict[str, torch.cuda.CUDAGraph] = {}
        self._variants: dict[str, Callable[[], None]] = {}
        for name in _VARIANTS:
            body = partial(self._block_body, name == "sampled")
            self._variants[name] = self._capture(name, body) \
                if cuda_graphs else body

    # ----------------------------------------------------------- submission
    def submit(self, request: Request,
               on_token: Callable | None = None, *,
               submit_t: float | None = None) -> int:
        """Queue a request; returns its id.  ``on_token(request_id, token,
        index)`` streams every generated token as it is harvested;
        ``submit_t`` (``time.perf_counter()`` domain) backdates arrival."""
        s = len(request.tokens)
        if not s:
            raise ValueError("empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if request.extra:
            raise NotImplementedError(
                "frontend inputs (Request.extra) are not ported to "
                "repro_torch yet (ROADMAP.md queue A item 9)")
        padded = s
        if self.config.prefill_chunk:
            padded = s + (-s) % self.config.prefill_chunk
        # the lane must hold every position written (chunk padding
        # included); the page commitment is only the real footprint
        lane_depth = max(s + request.max_new_tokens, padded)
        if lane_depth > self.config.max_seq:
            raise ValueError(
                f"request {request.request_id} needs {lane_depth} cache "
                f"slots (> max_seq={self.config.max_seq}); raise "
                f"EngineConfig.max_seq or shorten the request")
        rs = RequestState(
            request, on_token=on_token,
            submit_t=time.perf_counter() if submit_t is None else submit_t,
            need_tokens=s + request.max_new_tokens)
        self.scheduler.submit(rs)
        return request.request_id

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    @property
    def stats(self) -> EngineStats:
        return self._stats

    def compile_stats(self) -> dict[str, int]:
        """The reference's recompile detector, under its keys: for each
        prefill-side step, the distinct shapes it has run (what the
        reference's jit caches hold); for ``decode_block``, the body
        variants built (graphs captured, on CUDA), which admission, page
        churn and :meth:`reset` never add to."""
        keys = ["prefill", "refeed", "prefill_batched", "refeed_batched",
                "decode_block", "first_sample", "first_sample_batched",
                "admit_update", "admit_update_batched"]
        if self._paged:
            keys += ["prefill_scatter", "paged_admit", "paged_admit_refeed"]
        return {k: len(self._variants) if k == "decode_block"
                else len(self._shapes[k]) for k in keys}

    # ------------------------------------------------------------ admission
    def _bucket_key(self, rs: RequestState):
        """Prefill bucket: (padded prompt length, needs-refeed)."""
        s = len(rs.request.tokens)
        chunk = self.config.prefill_chunk
        padded = s + (-s) % chunk if chunk else s
        return (padded, padded != s)

    def _note_shapes(self, k: int, padded: int, refeed: bool,
                     batched: bool) -> None:
        """Record a prefill of ``k`` lanes of ``padded`` tokens under the
        reference's step names (``compile_stats``)."""
        note = self._shapes
        if not batched:
            note["prefill"].add(padded)
            if refeed:
                note["refeed"].add(())
            note["first_sample"].add(())
            note["admit_update"].add(())
            if self._paged:
                note["prefill_scatter"].add(())
            return
        if self._paged:
            note["paged_admit_refeed" if refeed else "paged_admit"].add(
                (k, padded))
        else:
            note["prefill_batched"].add((k, padded))
            if refeed:
                note["refeed_batched"].add(k)
        note["first_sample_batched"].add(k)
        note["admit_update_batched"].add(k)

    def _prefill_group(self, members, *, batched: bool = True
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """Prefill one bucket's ``(slot, RequestState)`` pairs in one
        call, commit their KV into the pool and load their slot state in
        place.  Returns (first tokens ``[K]``, still-active ``[K]``) on
        the device; nothing here waits for the device."""
        dev = self.device
        slots = [slot for slot, _ in members]
        reqs = [rs.request for _, rs in members]
        lens = [len(r.tokens) for r in reqs]
        padded, needs_refeed = self._bucket_key(members[0][1])
        self._note_shapes(len(members), padded, needs_refeed, batched)
        toks = np.zeros((len(reqs), padded), np.int32)
        for i, r in enumerate(reqs):
            toks[i, :lens[i]] = r.tokens
        depth = padded
        if self._paged:                  # lanes scatter in whole pages
            depth += (-padded) % self.config.page_size
            self.pool.extend_many(zip(slots, lens, strict=True))
        refeed = None
        if needs_refeed:
            refeed = (torch.tensor([r.tokens[-1] for r in reqs],
                                   dtype=torch.int32, device=dev),
                      torch.tensor([s - 1 for s in lens], dtype=torch.int32,
                                   device=dev))
        logits, lanes = slot_prefill(
            self.model, self.params, torch.tensor(toks, device=dev), depth,
            refeed)
        self.pool.commit(slots, lanes)

        sps = [r.sampling or SamplingParams() for r in reqs]
        u = []
        for slot, sp in zip(slots, sps, strict=True):
            gen = None
            if sp.temperature > 0:
                gen = torch.Generator().manual_seed(sp.seed)
            self._gens[slot] = gen
            u.append(draw_uniform(gen) if gen is not None else 0.0)
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        temp = torch.tensor([sp.temperature for sp in sps], **f32)
        top_k = torch.tensor([sp.top_k for sp in sps], **i32)
        eos = torch.tensor([-1 if r.eos_id is None else r.eos_id
                            for r in reqs], **i32)
        max_gen = torch.tensor([r.max_new_tokens for r in reqs], **i32)
        tok = self._sample(logits, temp, top_k, torch.tensor(u, **f32))
        # eos is -1 for "no stop token"; sampled ids are >= 0
        active = (max_gen > 1) & (tok != eos)

        idx = torch.tensor(slots, dtype=torch.long, device=dev)
        st = self._state
        st.token[idx] = tok
        st.pos[idx] = torch.tensor(lens, **i32)
        st.ngen[idx] = 1
        st.active[idx] = active
        st.temp[idx] = temp
        st.top_k[idx] = top_k
        st.eos[idx] = eos
        st.max_gen[idx] = max_gen
        self._stats.prompt_tokens += sum(lens)
        return tok, active

    def _admit(self, slot: int, rs: RequestState,
               finished: list[Completion]) -> None:
        """Serial admission: one prefill and one host sync per request."""
        t0 = time.perf_counter()
        tok, active = self._prefill_group([(slot, rs)], batched=False)
        tok0, alive = torch.stack([tok, active.to(torch.int32)]).tolist()
        now = time.perf_counter()
        rs.first_token_t = now
        self._stats.prefill_time_s += now - t0
        rs.emit(tok0[0])
        if not alive[0]:
            finished.append(self._finish_slot(slot))

    def _admit_batch(self, groups, finished: list[Completion]) -> None:
        """Batched admission: one prefill call per bucket and one host
        read for every first token of the tick."""
        t0 = time.perf_counter()
        pending = []
        for _key, members in groups:
            tok, active = self._prefill_group(members)
            self._stats.prefill_batches += 1
            pending.append((members, tok, active))
        host = torch.cat([torch.stack([tok, act.to(torch.int32)], 1)
                          for _, tok, act in pending]).tolist()
        now = time.perf_counter()
        self._stats.prefill_time_s += now - t0
        self._stats.admit_ticks += 1
        rows = iter(host)
        for members, _, _ in pending:
            for slot, rs in members:
                t, alive = next(rows)
                rs.first_token_t = now
                rs.emit(t)
                if not alive:
                    finished.append(self._finish_slot(slot))

    def _finish_slot(self, slot: int) -> Completion:
        rs = self.scheduler.finish(slot)
        self._gens[slot] = None
        req = rs.request
        stop = req.eos_id is not None and rs.tokens \
            and rs.tokens[-1] == req.eos_id
        now = time.perf_counter()
        comp = Completion(
            request_id=req.request_id, tokens=list(rs.tokens),
            n_prompt=len(req.tokens),
            finish_reason="stop" if stop else "length",
            ttft_s=(rs.first_token_t or now) - rs.submit_t,
            latency_s=now - rs.submit_t)
        st = self._stats
        st.requests_completed += 1
        st.generated_tokens += len(rs.tokens)
        st.ttft_s.append(comp.ttft_s)
        st.latency_s.append(comp.latency_s)
        return comp

    # ----------------------------------------------------------- decoding
    def _block_body(self, sampled: bool) -> None:
        """``decode_block`` slot-wide ticks over the static buffers, in
        place and with no host read: what a captured graph replays.
        Inactive lanes are masked, not skipped: they emit ``-1`` and their
        state freezes, and a tick with no lane active is masked whole.
        ``sampled`` draws each lane's token with the block's uniforms
        (``_u``); otherwise every lane takes the argmax."""
        st = self._state
        self._iters.zero_()
        for i in range(self.config.decode_block):
            if self._paged:
                logits = slot_decode_paged(
                    self.model, self.params, self.pool.arena, st.token,
                    st.pos, self._block_tables, st.active,
                    attn_scratch=self._attn_scratch)
            else:
                logits = slot_decode(self.model, self.params,
                                     self.pool.arena, st.token, st.pos,
                                     attn_scratch=self._attn_scratch)
            if self.last_logits is not None:
                self.last_logits[i].copy_(logits)
            if sampled:
                tok = self._sample(logits, st.temp, st.top_k, self._u[i])
            else:       # greedy fast path: skip the sort and the draw
                tok = logits.argmax(-1).to(torch.int32)
            was = st.active
            inc = was.to(torch.int32)
            self._iters.add_(inc.amax())       # 1 while some lane is live
            self._out[i].copy_(torch.where(was, tok, -1))
            ngen = st.ngen + inc
            live = was & (tok != st.eos) & (ngen < st.max_gen)
            st.token.copy_(torch.where(was, tok, st.token))
            st.pos.add_(inc)
            st.ngen.copy_(ngen)
            st.active.copy_(live)
        self._live.copy_(st.active)

    @torch.no_grad()
    def _capture(self, name: str, body: Callable[[], None]
                 ) -> Callable[[], None]:
        """Warm ``body`` up on a side stream (the kernels' first-use
        builds, cuBLAS handles, lazy allocations), capture it as a CUDA
        graph on that stream, and return its replay.  Runs while no lane
        is live: the warm-up really runs, every tick fully masked."""
        dev = self.device
        t0 = time.perf_counter()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            body()
        torch.cuda.current_stream(dev).wait_stream(stream)
        before = [fn.launches for fn in _KERNELS]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=stream):
                body()
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing the {name} decode block as a CUDA graph "
                f"failed (a host sync or an allocation the capture does "
                f"not allow?): {e}") from e
        torch.cuda.synchronize(dev)
        self.block_stats.captured_launches[name] = {
            fn.__name__: fn.launches - n
            for fn, n in zip(_KERNELS, before, strict=True)
            if fn.launches != n}
        self.block_stats.capture_s += time.perf_counter() - t0
        self.block_stats.graphs += 1
        self._graphs[name] = graph
        return graph.replay

    def _load_block_inputs(self) -> str:
        """Write the block's static inputs and return its variant.  Every
        running slot is active at block start, so the host knows which
        lanes sample: each draws ``decode_block`` uniforms from its own
        generator in tick order, as if it drew one per tick (a lane that
        finishes mid-block leaves its last draws unused, discarded with
        its generator), so its stream does not depend on the batch."""
        db = self.config.decode_block
        if self._paged:
            # back the block's worst-case frontier advance (tables are
            # constant within a block; admission committed it)
            for slot, rs in self.scheduler.running.items():
                pos = len(rs.request.tokens) + len(rs.tokens) - 1
                self.pool.extend(slot, pos + db)
            self._block_tables.copy_(torch.from_numpy(self.pool.block_tables))
        samplers = [(slot, gen) for slot, gen in enumerate(self._gens)
                    if gen is not None]
        if not samplers:
            return "greedy"
        u = np.zeros((db, self.config.slots), np.float32)
        for slot, gen in samplers:
            u[:, slot] = [draw_uniform(gen) for _ in range(db)]
        self._u.copy_(torch.from_numpy(u))
        return "sampled"

    @torch.no_grad()
    def step(self) -> list[Completion]:
        """One scheduling tick: admit into free slots, then run one decode
        block.  Returns requests that finished this tick."""
        finished: list[Completion] = []
        if self.config.batched_admission:
            groups = self.scheduler.admission_groups(self._bucket_key)
            if groups:
                self._admit_batch(groups, finished)
        else:
            admitted = self.scheduler.admissions()
            if admitted:
                self._stats.admit_ticks += 1
            for slot, rs in admitted:
                self._admit(slot, rs, finished)

        if self.scheduler.running:
            variant = self._load_block_inputs()
            t0 = time.perf_counter()
            self._variants[variant]()
            # ONE host read per block: emitted tokens, liveness, ticks run
            host = self._readback.cpu().numpy()
            self._stats.decode_time_s += time.perf_counter() - t0
            n, db = self.config.slots, self.config.decode_block
            out_host = host[:db * n].reshape(db, n)
            active_host = host[db * n:-1]
            n_iters = int(host[-1])
            self.block_stats.blocks[variant] += 1
            self.block_stats.ticks_run += n_iters
            st = self._stats
            st.decode_ticks += 1
            st.slot_ticks_total += n_iters * n
            for slot in list(self.scheduler.running):
                col = out_host[:, slot]
                toks = col[col >= 0]
                st.slot_ticks_active += len(toks)
                rs = self.scheduler.running[slot]
                for t in toks:
                    rs.emit(int(t))
                if not active_host[slot]:
                    finished.append(self._finish_slot(slot))
        self._completed.extend(finished)
        return finished

    # ----------------------------------------------------------- frontends
    def generate(self, requests, max_new_tokens: int | None = None, *,
                 sampling: SamplingParams | None = None,
                 eos_id: int | None = None):
        """Run requests to completion.  Two forms:

        * ``generate(list[Request])`` -> ``list[Completion]`` in request
          order (the engine API);
        * ``generate(tokens [B, S], max_new_tokens)`` -> int32 tokens
          ``[B, n]`` on the engine's device (the legacy array form,
          greedy unless ``sampling`` is given; ``n`` is
          ``max_new_tokens``, default 16, or the longest stream when
          every row stops early at ``eos_id``; a row that stops before
          ``n`` is padded with its last token, and ``max_new_tokens <=
          0`` gives ``[B, 0]``).
        """
        if not isinstance(requests, (list, tuple)):
            return self._generate_array(requests, max_new_tokens, sampling,
                                        eos_id)
        pending = {r.request_id for r in requests}
        done: dict[Any, Completion] = {}
        for r in requests:
            self.submit(r)
        while self.has_work and pending - set(done):
            for c in self.step():
                done[c.request_id] = c
        return [done[r.request_id] for r in requests]

    def _generate_array(self, tokens, max_new_tokens, sampling,
                        eos_id) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor):
            tokens = tokens.cpu().numpy()
        tokens = np.asarray(tokens)
        if max_new_tokens is None:
            max_new_tokens = 16
        b = tokens.shape[0]
        if max_new_tokens <= 0:
            return torch.zeros((b, 0), dtype=torch.int32, device=self.device)
        comps = self.generate([
            Request(tokens=[int(t) for t in tokens[i]],
                    max_new_tokens=max_new_tokens,
                    sampling=sampling or SamplingParams(), eos_id=eos_id)
            for i in range(b)])
        width = max(len(c.tokens) for c in comps)
        out = np.zeros((b, width), np.int32)
        for i, c in enumerate(comps):
            out[i, :len(c.tokens)] = c.tokens
            out[i, len(c.tokens):] = c.tokens[-1]   # early EOS: pad with it
        return torch.from_numpy(out).to(self.device)

    # -------------------------------------------------------------- control
    def take_completed(self) -> list[Completion]:
        """Drain and return the retained completion history (at most
        ``config.completed_cap``), oldest first."""
        out = list(self._completed)
        self._completed.clear()
        return out

    def drain(self) -> list[Completion]:
        """Step until idle; returns everything that finished.  The slot
        state is then zeroed in place."""
        out: list[Completion] = []
        while self.has_work:
            out.extend(self.step())
        self._state.zero_()
        return out

    def reset(self, *, params: Tree | None = None) -> "ServeEngine":
        """Clear queues, slot state and stats, keeping the pool and every
        built variant (no graph is captured again).  ``params`` (e.g.
        after more training) are copied into the engine's own parameter
        tensors in place, so a captured graph reads them at the addresses
        it was captured with; they must match those tensors' tree, shapes
        and dtypes."""
        if params is not None:
            self._load_params(params)
        self.scheduler.reset()
        self._state.zero_()
        self._gens = [None] * self.config.slots
        self._stats = EngineStats()
        self.block_stats.blocks.clear()
        self.block_stats.ticks_run = 0
        self._completed.clear()
        return self

    @torch.no_grad()
    def _load_params(self, params: Tree) -> None:
        pairs: list[tuple[torch.Tensor, torch.Tensor]] = []
        try:
            tree_map(lambda a, b: pairs.append((a, b)), self.params, params)
        except (KeyError, TypeError) as e:
            raise ValueError(f"params do not have the engine's tree: {e!r}"
                             ) from e
        for a, b in pairs:
            if a.shape != b.shape or a.dtype != b.dtype:
                raise ValueError(f"param {tuple(b.shape)} {b.dtype} where "
                                 f"the engine holds {tuple(a.shape)} "
                                 f"{a.dtype}")
        for a, b in pairs:
            a.copy_(b)
