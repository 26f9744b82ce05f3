"""KV-cache pools: contiguous slot arena and paged page pool.

Counterpart of ``repro.serve.cache``; the host-side bookkeeping (free
lists, page commitments, block tables) is the reference's, line for line,
so slot and page accounting match it exactly.

:class:`CachePool` holds the model's cache for ``n_slots`` lanes,
allocated once.  :class:`PagedCachePool` keeps KV in fixed-size pages of
a shared pool, mapped per slot through a block table; page 0 is a trash
page that absorbs masked and inactive writes and is never read.

Admission prefills a group of requests into transient lanes
(:func:`repro_torch.runtime.step.slot_prefill`) and :meth:`commit`
copies them into the pool: into the slots' lanes for the contiguous
arena, through :func:`prefill_scatter` into the slots' pages for the
paged pool.  The reference's paged pool keeps a persistent one-lane
scratch for serial admission; here every admission uses transient lanes
only as deep as the prompt bucket, so the pool holds no scratch and its
byte counts leave it out.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import upload

__all__ = ["CachePool", "PagedCachePool", "prefill_scatter"]

Tree = Any

SLOT_AXIS = 1  # cache leaves are [layers, lanes, ...]

TRASH_PAGE = 0  # reserved page: absorbs masked/inactive writes, never read


def _leaves(tree: Tree) -> list[torch.Tensor]:
    """Leaves of a cache: nested dicts (attention KV) or tuples (the
    Mamba-2 conv and SSM states)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _zip_leaves(a: Tree, b: Tree):
    if isinstance(a, dict):
        for k in a:
            yield from _zip_leaves(a[k], b[k])
    elif isinstance(a, tuple):
        for x, y in zip(a, b, strict=True):
            yield from _zip_leaves(x, y)
    else:
        yield a, b


class CachePool:
    """Fixed arena of ``n_slots`` cache lanes + a host-side free list."""

    backend = "contiguous"

    def __init__(self, model, n_slots: int, max_seq: int, *, device):
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.device = torch.device(device)
        self.arena: Tree = model.init_cache(n_slots, max_seq, device=device)
        for leaf in _leaves(self.arena):
            if leaf.dim() <= SLOT_AXIS or leaf.shape[SLOT_AXIS] != n_slots:
                raise ValueError(
                    f"cache leaf {tuple(leaf.shape)} does not carry the slot "
                    f"axis at axis {SLOT_AXIS}; CachePool requires "
                    "[layers, slots, ...] cache layouts")
        self._init_slots(n_slots)

    def _init_slots(self, n_slots: int) -> None:
        self._free: list[int] = list(range(n_slots - 1, -1, -1))
        self._is_free = bytearray([1]) * n_slots

    # ------------------------------------------------------------ free list
    @property
    def n_free(self) -> int:
        """Free slots, from the host free list."""
        return len(self._free)

    def alloc(self, need_tokens: int = 0) -> int | None:
        """Pop a free slot id, or None when the arena is full
        (``need_tokens`` matters only to paged pools)."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._is_free[slot] = 0
        return slot

    def free(self, slot: int) -> None:
        if not 0 <= slot < self.n_slots or self._is_free[slot]:
            raise ValueError(f"double free / bad slot {slot}")
        self._is_free[slot] = 1
        self._free.append(slot)

    def reset(self) -> None:
        """Release every slot (stale contents are unreadable: prefill
        rewrites ``[0, prompt)`` and attention masks past the frontier)."""
        self._init_slots(self.n_slots)

    # --------------------------------------------------------------- commit
    def commit(self, slots, lanes: Tree) -> None:
        """Copy K freshly prefilled lanes (leaves ``[layers, K, depth,
        ...]``) into the arena lanes of ``slots``."""
        idx = upload(slots, self.device, torch.long)
        for a, ln in _zip_leaves(self.arena, lanes):
            a[:, idx, :ln.shape[2]] = ln

    # ----------------------------------------------------------- accounting
    def kv_bytes(self) -> int:
        """Device bytes held by the cache arrays."""
        return sum(x.numel() * x.element_size() for x in _leaves(self.arena))


def prefill_scatter(pages: Tree, lanes: Tree, bt_rows: torch.Tensor,
                    page_size: int) -> None:
    """Copy K prefilled lanes into the page pool, in place.

    ``pages`` leaves are ``[layers, n_pages, page_size, ...]``; ``lanes``
    leaves ``[layers, K, depth, ...]`` with ``depth`` a multiple of
    ``page_size``; ``bt_rows [K, max_blocks]`` the slots' block-table
    rows (K = 1 is the serial admission).  Every block of every lane is
    scattered unconditionally: rows are trash-page-padded past each
    slot's allocated prefix, so pad blocks land on page 0, where
    colliding writes are harmless because it is never read.
    """
    for pg, ln in _zip_leaves(pages, lanes):
        k, depth = ln.shape[1], ln.shape[2]
        nb = depth // page_size
        blocks = ln.reshape((ln.shape[0], k, nb, page_size)
                            + tuple(ln.shape[3:]))
        pg[:, bt_rows[:, :nb].long()] = blocks


class PagedCachePool(CachePool):
    """Block-table KV pool: slots share ``n_pages`` fixed-size pages.

    Device state: ``arena``, the model's page pool (leaves ``[layers,
    n_pages, page_size, ...]``, page 0 the trash page), allocated once.
    Host state: ``block_tables`` (``[n_slots, max_blocks]`` numpy int32,
    copied into the engine's device table before each decode block),
    the page free list and per-slot page commitments.  Admission reserves the worst-case
    ``ceil(need / page_size)`` pages up front, so ``extend`` never fails
    mid-flight; pages are handed out lazily as the decode frontier
    crosses block boundaries, so ``peak_pages_in_use`` tracks traffic.
    """

    backend = "paged"

    def __init__(self, model, n_slots: int, max_seq: int, *,
                 page_size: int, n_pages: int | None = None, device):
        if not getattr(model, "supports_paged_kv", False):
            raise ValueError(
                f"{type(model).__name__} does not support a paged KV "
                "cache (recurrent state lanes are fixed-size per slot) — "
                "use kv_backend='contiguous'")
        if max_seq % page_size:
            raise ValueError(
                f"max_seq={max_seq} must be a multiple of "
                f"page_size={page_size}")
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.device = torch.device(device)
        self.page_size = page_size
        self.max_blocks = max_seq // page_size
        worst = n_slots * self.max_blocks
        self.n_pages = worst + 1 if n_pages is None else n_pages
        if self.n_pages < 2:
            raise ValueError("n_pages must be >= 2 (page 0 is reserved)")

        self.arena: Tree = model.init_paged_cache(self.n_pages, page_size,
                                                  device=device)
        self.block_tables = np.zeros((n_slots, self.max_blocks), np.int32)
        self._init_slots(n_slots)
        self._init_pages()

    def _init_pages(self) -> None:
        self._free_pages: list[int] = list(range(self.n_pages - 1, 0, -1))
        self._pages_of: list[list[int]] = [[] for _ in range(self.n_slots)]
        self._commit_pages = [0] * self.n_slots
        self._committed_total = 0
        self.pages_in_use = 0
        self.peak_pages_in_use = 0

    # ----------------------------------------------------------- page maths
    @property
    def n_usable_pages(self) -> int:
        return self.n_pages - 1

    @property
    def n_free_pages(self) -> int:
        """Pages on the host free list (page 0 is never on it)."""
        return len(self._free_pages)

    def pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    # ------------------------------------------------------- admit / extend
    def alloc(self, need_tokens: int = 0) -> int | None:
        """Admit: reserve a slot *and* its worst-case page commitment, or
        return None (the request stays queued) when either runs short."""
        need = self.pages_needed(need_tokens)
        if not self._free \
                or self._committed_total + need > self.n_usable_pages:
            return None
        slot = super().alloc()
        self._commit_pages[slot] = need
        self._committed_total += need
        return slot

    def extend(self, slot: int, n_tokens: int) -> None:
        """Materialize pages so positions ``[0, n_tokens)`` of ``slot``
        are backed (clamped to the slot's admission commitment)."""
        if self._is_free[slot]:
            raise ValueError(f"extend on free slot {slot}")
        if n_tokens > 0 and not self._commit_pages[slot]:
            raise ValueError(
                f"slot {slot} was admitted without a page commitment — "
                "pass the request's need_tokens to alloc()")
        want = min(self.pages_needed(n_tokens), self._commit_pages[slot])
        row = self._pages_of[slot]
        while len(row) < want:
            if not self._free_pages:    # unreachable if commitments hold
                raise RuntimeError(
                    "page pool exhausted past its commitments — "
                    "allocator invariant violated")
            page = self._free_pages.pop()
            self.block_tables[slot, len(row)] = page
            row.append(page)
        self.pages_in_use = self.n_usable_pages - len(self._free_pages)
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.pages_in_use)

    def extend_many(self, pairs) -> None:
        """:meth:`extend` for several ``(slot, n_tokens)`` pairs."""
        for slot, n_tokens in pairs:
            self.extend(slot, n_tokens)

    def free(self, slot: int) -> None:
        super().free(slot)
        self._free_pages.extend(reversed(self._pages_of[slot]))
        self._pages_of[slot] = []
        self._committed_total -= self._commit_pages[slot]
        self._commit_pages[slot] = 0
        self.block_tables[slot, :] = TRASH_PAGE
        self.pages_in_use = self.n_usable_pages - len(self._free_pages)

    def reset(self) -> None:
        self._init_slots(self.n_slots)
        self._init_pages()
        self.block_tables[:] = TRASH_PAGE

    # --------------------------------------------------------------- commit
    def commit(self, slots, lanes: Tree) -> None:
        """Scatter K prefilled lanes into the pages of ``slots`` (call
        :meth:`extend` for the prompts first)."""
        prefill_scatter(self.arena, lanes, self.block_table_rows(slots),
                        self.page_size)

    # ----------------------------------------------------------- accounting
    def block_table_row(self, slot: int) -> torch.Tensor:
        """``[max_blocks]`` int32 block-table row of ``slot`` on the pool's
        device, copied from the host table."""
        return upload(self.block_tables[slot], self.device)

    def block_table_rows(self, slots) -> torch.Tensor:
        """``[K, max_blocks]`` int32 device rows for one admission group."""
        rows = self.block_tables[np.asarray(slots, np.int64)]
        return upload(rows, self.device)

    def device_block_tables(self) -> torch.Tensor:
        """The whole ``[n_slots, max_blocks]`` int32 table on the pool's
        device, copied from the host table."""
        return upload(self.block_tables, self.device)

    def page_bytes(self) -> int:
        """Device bytes of ONE page across every layer and leaf."""
        return sum(x.numel() * x.element_size() // self.n_pages
                   for x in _leaves(self.arena))

    def peak_kv_bytes(self) -> int:
        """High-water footprint a right-sized pool would have needed:
        peak live pages plus the trash page, and the block tables."""
        return (self.peak_pages_in_use + 1) * self.page_bytes() \
            + self.block_tables.nbytes
