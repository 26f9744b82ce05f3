"""EngineConfig — the (hashable) shape contract of a ``ServeEngine``.

A framework-free copy of ``repro.serve.config``.  The KV arena is
``[layers, n_slots, max_seq, ...]`` (or a page pool), the decode block
always runs over all ``n_slots`` lanes, and admitting or finishing a
request never changes a shape, so it never reallocates.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["EngineConfig"]


@dataclass(frozen=True)
class EngineConfig:
    """Static serving-engine shape/scheduling parameters.

    ``max_batch``
        Cap on concurrently *running* requests (scheduler admission limit).
    ``max_seq``
        Per-slot cache capacity; every request needs
        ``prefix + len(prompt) + max_new_tokens <= max_seq`` (``prefix`` =
        vision patch count for VLM frontends, else 0).
    ``n_slots``
        KV-cache slots in the arena (``None`` = ``max_batch``).  The fused
        decode step is compiled for exactly this width.
    ``prefill_chunk``
        If set, prompt lengths are right-padded up to a multiple of this
        value so at most ``max_seq / prefill_chunk`` prefill shapes
        ever occur; the true last-prompt-token logits are recovered with
        one extra decode step.  Only valid for position-indexed
        (attention-KV) caches — recurrent-state families (mamba2,
        recurrentgemma) fold padding steps into their state, so the
        engine rejects the option for models without
        ``kv_position_indexed`` (use the default, ``None``).
    ``decode_block``
        Decode ticks run back to back between scheduler interventions (admission happens at block boundaries).
        The block exits early once every lane is inactive.
    ``max_prefills_per_tick``
        Admission budget per scheduler tick (``None`` = fill every free
        slot).  Lower values keep decode latency smooth under a prefill
        backlog ("decode-priority" interleave).
    ``kv_backend``
        ``"contiguous"`` (default): one ``max_seq``-deep lane per slot.
        ``"paged"``: KV lives in ``page_size``-token pages of a shared
        pool addressed through per-slot block tables
        (:class:`repro_torch.serve.cache.PagedCachePool`), so each request only
        holds its own footprint.  KV-cache families (transformer / moe /
        mla) support it; recurrent-state
        families (mamba2, recurrentgemma) and the audio cross-KV decoder
        have fixed-size lanes with nothing to page and reject it.
    ``page_size``
        Tokens per KV page (paged backend only).  ``max_seq`` must be a
        multiple of it.
    ``kv_pages``
        Total pages in the pool, including the reserved trash page
        (``None`` = worst case, ``n_slots * max_seq / page_size + 1`` —
        the contiguous footprint).  Sizing it below worst case is where
        the memory win comes from: admission defers (requests queue)
        instead of over-committing when pages run short.
    ``batched_admission``
        ``True`` (default): each tick's admissions are grouped by
        prefill-shape bucket and every group prefills in ONE
        slot-batched call, with all first tokens of the tick landing in
        a single host sync — the fix for per-request prefill dispatch
        serializing admission-heavy traffic.  ``False`` keeps the
        original one-prefill-one-sync-per-request path (the equivalence
        oracle; token streams are identical under greedy decoding).
    ``completed_cap``
        Retained-history bound for completions nobody drains: the
        engine keeps at most this many finished :class:`Completion`
        records for :meth:`~repro_torch.serve.engine.ServeEngine.take_completed`
        (oldest dropped first), so a long-running server that never
        calls ``reset()`` holds bounded memory.
    """

    max_batch: int = 8
    max_seq: int = 256
    n_slots: int | None = None
    prefill_chunk: int | None = None
    decode_block: int = 8
    max_prefills_per_tick: int | None = None
    kv_backend: str = "contiguous"
    page_size: int = 16
    kv_pages: int | None = None
    batched_admission: bool = True
    completed_cap: int = 1024

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.n_slots is not None and self.n_slots < self.max_batch:
            raise ValueError("n_slots must be >= max_batch")
        if self.decode_block < 1:
            raise ValueError("decode_block must be >= 1")
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if self.completed_cap < 1:
            raise ValueError("completed_cap must be >= 1")
        if self.kv_backend not in ("contiguous", "paged"):
            raise ValueError(
                f"kv_backend must be 'contiguous' or 'paged', "
                f"got {self.kv_backend!r}")
        if self.kv_backend == "paged":
            if self.page_size < 1:
                raise ValueError("page_size must be >= 1")
            if self.max_seq % self.page_size:
                raise ValueError(
                    f"max_seq={self.max_seq} must be a multiple of "
                    f"page_size={self.page_size}")
            if self.kv_pages is not None and self.kv_pages < 2:
                raise ValueError("kv_pages must be >= 2 (page 0 is "
                                 "the reserved trash page)")

    @property
    def slots(self) -> int:
        return self.n_slots if self.n_slots is not None else self.max_batch
