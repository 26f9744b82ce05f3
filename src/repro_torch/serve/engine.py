"""ServeEngine — continuous-batching inference over a slot-pooled cache.

Counterpart of ``repro.serve.engine`` for the dense decoder (both cache
backends) and Mamba-2 (the contiguous backend: its lanes are a fixed
conv window and SSM state, with nothing to page).  Requests
are data (:class:`~repro_torch.serve.types.Request`), admission is the
:class:`~repro_torch.serve.scheduler.Scheduler`'s, and decoding runs
``decode_block`` slot-wide ticks between scheduler interventions, with
per-slot EOS and length masking.

Where the reference fuses a decode block into one ``lax.while_loop``
that exits once no lane is active, the port runs up to ``decode_block``
ticks in Python and reads ``active.any()`` once per tick — one small
host sync per tick.  The emitted tokens of the whole block still reach
the host in one read, and ``slot_ticks_total`` / ``slot_ticks_active``
count exactly as the reference counts them.

Admission: with ``batched_admission`` (the default) each tick's
admissions are grouped by prefill bucket, each group prefills in one
slot-batched call, and all first tokens of the tick reach the host in
one read; ``batched_admission=False`` prefills and syncs per request.
Both give the same greedy token streams.

Two entry points::

    engine.generate(requests)              # synchronous, list[Completion]
    rid = engine.submit(req, on_token=cb)  # incremental / streaming
    while engine.has_work:
        engine.step()                      # one admission + decode tick

Frontends (vision patches, audio frames) are not ported yet.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve_device
from ..runtime.step import slot_decode, slot_decode_paged, slot_prefill
from .cache import CachePool, PagedCachePool
from .config import EngineConfig
from .sampling import draw_uniform, make_token_sampler
from .scheduler import RequestState, Scheduler
from .types import Completion, EngineStats, Request, SamplingParams

__all__ = ["ServeEngine"]

Tree = Any


@dataclass
class _SlotState:
    """Per-slot decode state on the device, all ``[n_slots]``.  ``pos``
    is the next KV write index, ``token`` the last sampled token."""

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


class ServeEngine:
    """Continuous-batching generation engine for one model replica.

    ``params`` must already live on ``device`` (the GPU unless
    ``device="cpu"`` is passed).
    """

    def __init__(self, model, params: Tree,
                 config: EngineConfig | None = None, *, device=None):
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params live on {table.device}, the engine "
                             f"runs on {self.device}")
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
                n_pages=self.config.kv_pages, device=self.device)
        else:
            self.pool = CachePool(model, self.config.slots,
                                  self.config.max_seq, device=self.device)
        self.scheduler = Scheduler(
            self.pool, max_batch=self.config.max_batch,
            max_prefills_per_tick=self.config.max_prefills_per_tick)
        self._sample = make_token_sampler(model.cfg.vocab)
        self._state = _SlotState.zeros(self.config.slots, self.device)
        # per-slot host generator of a sampling request (None: greedy)
        self._gens: list[torch.Generator | None] = [None] * self.config.slots
        self._stats = EngineStats()
        self._completed: deque[Completion] = deque(
            maxlen=self.config.completed_cap)

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

    # ------------------------------------------------------------ admission
    def _bucket_key(self, rs: RequestState):
        """Prefill bucket: (padded prompt length, needs-refeed)."""
        s = len(rs.request.tokens)
        chunk = self.config.prefill_chunk
        padded = s + (-s) % chunk if chunk else s
        return (padded, padded != s)

    def _prefill_group(self, members) -> tuple[torch.Tensor, torch.Tensor]:
        """Prefill one bucket's ``(slot, RequestState)`` pairs in one
        call, commit their KV into the pool and load their slot state.
        Returns (first tokens ``[K]``, still-active ``[K]``) on the
        device; nothing here waits for the device."""
        dev = self.device
        slots = [slot for slot, _ in members]
        reqs = [rs.request for _, rs in members]
        lens = [len(r.tokens) for r in reqs]
        padded, needs_refeed = self._bucket_key(members[0][1])
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
        tok, active = self._prefill_group([(slot, rs)])
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
    def _decode_block(self, block_tables: torch.Tensor | None
                      ) -> tuple[torch.Tensor, int]:
        """Up to ``decode_block`` slot-wide ticks; stops early once no
        lane is active.  Inactive lanes are masked, not skipped: they
        emit ``-1`` and their state freezes.  Returns (emitted
        ``[n_steps, n_slots]``, ticks run)."""
        st = self._state
        n_slots = self.config.slots
        out = torch.full((self.config.decode_block, n_slots), -1,
                         dtype=torch.int32, device=self.device)
        # every running slot is active at block start, so the host knows
        # which lanes sample; a lane that finishes mid-block may draw a
        # few extra numbers from its generator, which is discarded with it
        samplers = [(slot, gen) for slot, gen in enumerate(self._gens)
                    if gen is not None]
        i = 0
        while i < self.config.decode_block and bool(st.active.any()):
            if self._paged:
                logits = slot_decode_paged(self.model, self.params,
                                           self.pool.arena, st.token,
                                           st.pos, block_tables, st.active)
            else:
                logits = slot_decode(self.model, self.params,
                                     self.pool.arena, st.token, st.pos)
            if samplers:
                u = [0.0] * n_slots
                for slot, gen in samplers:
                    u[slot] = draw_uniform(gen)
                tok = self._sample(logits, st.temp, st.top_k,
                                   torch.tensor(u, device=self.device))
            else:       # greedy fast path: skip the sort and the draw
                tok = logits.argmax(-1).to(torch.int32)
            was = st.active
            out[i] = torch.where(was, tok, -1)
            ngen = st.ngen + was.to(torch.int32)
            st.token = torch.where(was, tok, st.token)
            st.pos = st.pos + was.to(torch.int32)
            st.ngen = ngen
            st.active = was & (tok != st.eos) & (ngen < st.max_gen)
            i += 1
        return out, i

    @torch.no_grad()
    def step(self) -> list[Completion]:
        """One scheduling tick: admit into free slots, then run one
        decode block.  Returns requests that finished this tick."""
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
            block_tables = None
            if self._paged:
                # back the block's worst-case frontier advance (tables
                # are constant within a block; admission committed it)
                for slot, rs in self.scheduler.running.items():
                    pos = len(rs.request.tokens) + len(rs.tokens) - 1
                    self.pool.extend(slot, pos + self.config.decode_block)
                block_tables = self.pool.device_block_tables()
            t0 = time.perf_counter()
            out, n_iters = self._decode_block(block_tables)
            # ONE host read per block: emitted tokens and liveness
            host = torch.cat([out.flatten(),
                              self._state.active.to(torch.int32)]).cpu()
            self._stats.decode_time_s += time.perf_counter() - t0
            out_host = host[:out.numel()].view(out.shape).numpy()
            active_host = host[out.numel():].numpy()
            st = self._stats
            st.decode_ticks += 1
            st.slot_ticks_total += n_iters * self.config.slots
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
    def generate(self, requests: list[Request]) -> list[Completion]:
        """Run ``requests`` to completion; completions in request order."""
        pending = {r.request_id for r in requests}
        done: dict[Any, Completion] = {}
        for r in requests:
            self.submit(r)
        while self.has_work and pending - set(done):
            for c in self.step():
                done[c.request_id] = c
        return [done[r.request_id] for r in requests]

    # -------------------------------------------------------------- control
    def take_completed(self) -> list[Completion]:
        """Drain and return the retained completion history (at most
        ``config.completed_cap``), oldest first."""
        out = list(self._completed)
        self._completed.clear()
        return out
