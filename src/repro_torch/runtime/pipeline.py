"""Depth-k host->device data staging at period granularity.

Counterpart of ``repro.runtime.pipeline``.  The fused runner consumes one
period of batches per dispatch.  :class:`PeriodPrefetcher` builds up to
``depth`` future periods while the current one runs: ``get()`` hands back
the already-staged batch, the runner dispatches the period's steps, then
calls :meth:`prefetch` for the following periods *before* it waits for
the device.

Two staging modes:

* ``background=False`` (default) — staging happens inline on the caller
  thread, after the period's kernels are queued, so the host-side batch
  build overlaps the device's work.
* ``background=True`` — a daemon thread drains a staging queue, so
  host-side batch construction also moves off the training thread.
  ``get()`` blocks on the slot's event if the batch is still being built.

Each period batch is a pure function of its start step (``data.batch``
is deterministic), so batches are identical across depths and modes.
"""

from __future__ import annotations

import queue
import threading
from typing import Any

import torch

from ..tree import tree_map

__all__ = ["PeriodPrefetcher", "stack_period_batches"]

Tree = Any


def stack_period_batches(data: Any, start: int, h: int) -> Tree:
    """Batches for iterations ``[start, start + h)`` stacked on a new
    leading phase axis."""
    batches = [data.batch(r) for r in range(start, start + h)]
    return tree_map(lambda *xs: torch.stack(xs), *batches)


class _Slot:
    """One staged (or in-flight) period batch."""

    __slots__ = ("ready", "value", "error")

    def __init__(self):
        self.ready = threading.Event()
        self.value: Tree | None = None
        self.error: BaseException | None = None

    def fill(self, value: Tree) -> None:
        self.value = value
        self.ready.set()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self.ready.set()

    def take(self) -> Tree:
        self.ready.wait()
        if self.error is not None:
            raise self.error
        value, self.value = self.value, None
        return value


class PeriodPrefetcher:
    """Depth-``k`` staging of period training batches.

    ``stacked=True`` yields the ``[H, ...]`` layout; ``stacked=False``
    yields the list of H per-step batches the pipeline-mode runner feeds
    its per-phase steps.

    Only the owning (training) thread mutates the staging map; the
    background worker touches only slot objects it was handed through
    the queue, and a generation counter lets :meth:`invalidate` orphan
    in-flight work without joining the thread.
    """

    def __init__(self, data: Any, h: int, *, stacked: bool = True,
                 depth: int = 1, background: bool = False):
        self.data = data
        self.h = h
        self.stacked = stacked
        self.depth = max(1, depth)
        self.background = background
        self._staged: dict[int, _Slot] = {}
        self._gen = 0
        self._queue: queue.Queue | None = None
        self._thread: threading.Thread | None = None

    def _build(self, start: int) -> Tree:
        if self.stacked:
            return stack_period_batches(self.data, start, self.h)
        return [self.data.batch(r) for r in range(start, start + self.h)]

    # -------------------------------------------------------- background
    def _ensure_worker(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._queue = queue.Queue()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="period-prefetch")
        self._thread.start()

    def _worker(self) -> None:
        while True:
            gen, start, slot = self._queue.get()
            if gen != self._gen:
                # orphaned by invalidate(); nobody will take() this slot
                slot.fail(RuntimeError("prefetch invalidated"))
                continue
            try:
                slot.fill(self._build(start))
            except BaseException as e:              # surfaced in take()
                slot.fail(e)

    def _stage(self, start: int) -> None:
        slot = _Slot()
        self._staged[start] = slot
        if self.background:
            self._ensure_worker()
            self._queue.put((self._gen, start, slot))
        else:
            try:
                slot.fill(self._build(start))
            except BaseException as e:
                slot.fail(e)

    # ---------------------------------------------------------- interface
    def get(self, start: int) -> Tree:
        """The period batch for iterations ``[start, start + H)`` —
        already staged if :meth:`prefetch` predicted this start (the
        common case), built on the spot otherwise.  Also drops any staged
        periods *before* ``start``."""
        for s in [s for s in self._staged if s < start]:
            del self._staged[s]
        slot = self._staged.pop(start, None)
        if slot is not None:
            return slot.take()
        return self._build(start)

    def prefetch(self, start: int, *, last: int | None = None) -> None:
        """Stage the periods ``start, start + H, ...`` up to ``depth``
        entries (call right after dispatching the current period, before
        waiting for it).  ``last`` clamps staging to period starts
        ``<= last`` so a run tail never builds batches past its end."""
        for i in range(self.depth):
            s = start + i * self.h
            if last is not None and s > last:
                break
            if s not in self._staged:
                self._stage(s)

    def invalidate(self) -> None:
        """Drop staged work (plan/data changed under us)."""
        self._gen += 1
        self._staged.clear()
