"""Continuous-batching scheduler: waiting queue -> slots -> completions.

A framework-free copy of ``repro.serve.scheduler``.

Decode-priority policy: running requests decode every tick; at each tick
boundary the scheduler admits waiting requests into freed slots, FIFO, up
to the per-tick prefill budget and the engine's ``max_batch`` — so a long
prefill backlog interleaves with decoding instead of stalling it (the
DreamDDP lesson applied to serving: schedule heterogeneous work
fine-grained instead of in monolithic batches).

The scheduler is pure bookkeeping (host-side); all device work lives in
the engine.  Per-request progress is tracked in :class:`RequestState`.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Hashable

from .cache import CachePool
from .types import Request

__all__ = ["RequestState", "Scheduler"]


@dataclass
class RequestState:
    """Host-side progress record for one submitted request."""

    request: Request
    on_token: Callable | None = None       # (request_id, token, index)
    submit_t: float = 0.0
    admit_t: float | None = None           # given a slot
    first_token_t: float | None = None
    slot: int | None = None
    tokens: list[int] = field(default_factory=list)
    finish_reason: str = "length"
    need_tokens: int = 0                   # worst-case cache footprint

    @property
    def n_generated(self) -> int:
        return len(self.tokens)

    def emit(self, token: int) -> None:
        self.tokens.append(token)
        if self.on_token is not None:
            self.on_token(self.request.request_id, token,
                          len(self.tokens) - 1)


class Scheduler:
    """FIFO admission into a :class:`CachePool`, decode-priority."""

    def __init__(self, pool: CachePool, *, max_batch: int,
                 max_prefills_per_tick: int | None = None):
        self.pool = pool
        self.max_batch = max_batch
        self.max_prefills_per_tick = max_prefills_per_tick
        self.waiting: deque[RequestState] = deque()
        self.running: dict[int, RequestState] = {}     # slot -> state
        self.in_flight_ids: set[Any] = set()           # waiting + running

    # --------------------------------------------------------------- queues
    def submit(self, rs: RequestState) -> None:
        rid = rs.request.request_id
        if rid in self.in_flight_ids:
            raise ValueError(
                f"request_id {rid!r} is already in flight — completions "
                "are keyed by id, so a duplicate would be silently "
                "dropped; wait for the first submission to finish or use "
                "a fresh id")
        self.in_flight_ids.add(rid)
        self.waiting.append(rs)

    def admissions(self) -> list[tuple[int, RequestState]]:
        """Pop (slot, request) pairs admissible this tick.

        Admission is FIFO and capacity-aware: the head request's
        worst-case footprint (``need_tokens``) is offered to the pool,
        and a paged pool that cannot commit enough pages rejects the
        admission — the request stays queued (head-of-line, so ordering
        is preserved) until retirements free capacity.  Each admitted
        request's ``admit_t`` is stamped (``time.perf_counter()``).
        """
        budget = self.max_prefills_per_tick
        out: list[tuple[int, RequestState]] = []
        while self.waiting and len(self.running) < self.max_batch \
                and (budget is None or len(out) < budget):
            slot = self.pool.alloc(self.waiting[0].need_tokens)
            if slot is None:
                break
            rs = self.waiting.popleft()
            rs.slot = slot
            rs.admit_t = time.perf_counter()
            self.running[slot] = rs
            out.append((slot, rs))
        return out

    def admission_groups(self, key: Callable[[RequestState], Hashable]
                         ) -> list[tuple[Hashable, list[tuple[int,
                                                              "RequestState"]]]]:
        """Pop this tick's admissions and group them by prefill bucket.

        Admission itself stays FIFO and capacity-aware (exactly
        :meth:`admissions` — grouping never changes *who* is admitted,
        only how the admitted set is executed): the popped set is
        partitioned by ``key(rs)`` — the engine's prefill-shape bucket
        (padded prompt length, refeed-or-not, frontend extra shapes) —
        so each group can prefill in one slot-batched call.  Groups come
        back in first-appearance order; members keep FIFO order.
        """
        groups: dict[Hashable, list[tuple[int, RequestState]]] = {}
        for slot, rs in self.admissions():
            groups.setdefault(key(rs), []).append((slot, rs))
        return list(groups.items())

    def finish(self, slot: int) -> RequestState:
        """Retire the request in ``slot`` and free the slot for reuse."""
        rs = self.running.pop(slot)
        rs.slot = None
        self.in_flight_ids.discard(rs.request.request_id)
        self.pool.free(slot)
        return rs

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def reset(self) -> None:
        self.waiting.clear()
        self.running.clear()
        self.in_flight_ids.clear()
        self.pool.reset()
