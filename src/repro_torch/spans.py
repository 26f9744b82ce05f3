"""The port's timing instrumentation: host spans and device phase marks.

:func:`span` is the port's one range mechanism.  It names a stretch of
host work ``repro_torch.<loop>.<part>`` (``repro_torch.serve.block``,
``repro_torch.train.drain``, ...) for ``torch.profiler``: a profile
then files every device operation the stretch launched, and every idle
gap of the device while the host was in it, under that name.  With no
profiler recording it costs one flag read and dispatches nothing.

A span is a host range: under a CUDA graph replay it is recorded once,
at capture, and never again.  :class:`PhaseMarks` times what a replay
hides.  It records a device boundary at the start of a training period
and after each part of each phase step (the per-worker forward and
backward, the optimizer, the layer-wise sync), as timing events that a
captured graph holds as nodes of its own, so every replay records them
again.  On the CPU a mark is ``time.perf_counter()``, where every op has
finished when it returns.  :meth:`PhaseMarks.read`, once the device has
finished the period, gives each phase's seconds by part.
"""

from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["span", "PARTS", "PhaseMarks"]

_OFF = contextlib.nullcontext()

# the parts of one phase step, each timed from the mark before it
PARTS = ("grads", "optimizer", "sync")


def span(name: str):
    """A context naming its host work ``name`` in a ``torch.profiler``
    trace; a shared no-op context when no profiler is recording."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


class PhaseMarks:
    """Device boundaries of one period of ``H`` phase steps: mark 0 at
    the period's start, then one mark after each part of each phase,
    ``3H + 1`` in all.

    :meth:`phase` gives phase ``h``'s recorder, ``mark(part)``.  A part
    marked again within its phase moves its boundary (a straggler
    make-up's extra sync ends the sync part).  Each phase keeps the order
    in which its parts were first marked (a gradient-averaging plan syncs
    before the optimizer), and a part's seconds run from the mark before
    it, the previous phase's last mark for the first.  The order is set
    by the host at the first run of the body, which a captured graph
    replays as it is.
    """

    def __init__(self, n_phases: int):
        self.n_phases = n_phases
        self._times = [0.0] * (1 + len(PARTS) * n_phases)
        # on CUDA, timing events made at the first start there; external:
        # a capture holds each record as a graph node
        self._events: list[torch.cuda.Event] | None = None
        self._cuda = False
        self._order: list[list[str]] = [[] for _ in range(n_phases)]

    def _record(self, i: int) -> None:
        if self._cuda:
            self._events[i].record()
        else:
            self._times[i] = time.perf_counter()

    def start(self, device: torch.device) -> None:
        """Mark the period's start; the period runs on ``device``."""
        self._cuda = device.type == "cuda"
        if self._cuda and self._events is None:
            self._events = [torch.cuda.Event(enable_timing=True,
                                             external=True)
                            for _ in self._times]
        self._record(0)

    def phase(self, h: int):
        """Phase ``h``'s recorder: ``mark(part)``, ``part`` in
        :data:`PARTS`."""
        order = self._order[h]
        base = 1 + len(PARTS) * h

        def mark(part: str) -> None:
            if part not in order:
                order.append(part)
            self._record(base + PARTS.index(part))

        return mark

    def read(self) -> list[dict[str, float]]:
        """Per phase, ``{grads_s, optimizer_s, sync_s}``: call once the
        device has finished the period (on CUDA: after a synchronize)."""
        rows, prev = [], 0.0
        for h, order in enumerate(self._order):
            row = dict.fromkeys((f"{p}_s" for p in PARTS), 0.0)
            for part in order:
                at = self._since_start(1 + len(PARTS) * h
                                       + PARTS.index(part))
                row[f"{part}_s"] = at - prev
                prev = at
            rows.append(row)
        return rows

    def _since_start(self, i: int) -> float:
        """Seconds from mark 0 to mark ``i``."""
        if self._cuda:
            return self._events[0].elapsed_time(self._events[i]) / 1e3
        return self._times[i] - self._times[0]
