"""A profiled slice of a run: the device's operations from
``torch.profiler``'s trace, what the host was doing in each idle gap,
and the breakdown a traced run prints."""

from __future__ import annotations

import bisect

import torch

from .costs import kernel_class

SLICE = "perfbench.slice"
SHORT_GAP_US = 20          # shorter idle gaps are launch spacing, summed


def host_op(host, starts, t: float, reach: int = 5000) -> str:
    """The innermost host operation running at ``t``: the latest to start
    of those that contain it (``host`` sorted by start)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - reach), -1):
        start, end, name = host[j]
        if end >= t and name != SLICE:
            return name
    return "no host op"


def merged(spans):
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profile_slice(fn, classes: dict[str, tuple[str, ...]]) -> dict:
    """Run ``fn()`` under the profiler, then wait for the device.
    Returns ``kernels`` (name, start, end) of every device operation in
    the slice, in microseconds of the trace's clock, ordered by start;
    ``window_s``, the slice's length; ``busy_s``, the time in
    which some device operation ran; ``breakdown``, device seconds by
    kernel class (``classes``: hand-written kernels' name keys by class)
    and idle seconds by what the host was doing, the ten largest of
    each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SLICE):
            fn()
            torch.cuda.synchronize()
    kernels, host = [], []
    lo = hi = None
    events = prof.events()
    ranges = {ev.name for ev in events if ev.device_type != DeviceType.CUDA}
    for ev in events:
        tr = ev.time_range
        if ev.device_type != DeviceType.CUDA:
            host.append((tr.start, tr.end, ev.name))
            if ev.name == SLICE:
                lo, hi = tr.start, tr.end
        elif ev.name not in ranges and not getattr(
                ev, "is_user_annotation", False):
            # a host range (record_function) also shows on the device's
            # timeline, spanning its kernels: it is no operation
            kernels.append((ev.name, tr.start, tr.end))
    if not kernels:
        raise RuntimeError("the profiler saw no device operation in the "
                           "slice")
    if lo is None:
        lo, hi = min(k[1] for k in kernels), max(k[2] for k in kernels)
    kernels.sort(key=lambda k: k[1])
    busy = merged((max(a, lo), min(b, hi)) for _, a, b in kernels
                  if b > lo and a < hi)
    busy_us = sum(b - a for a, b in busy)
    by_class: dict[str, float] = {}
    for name, a, b in kernels:
        c = kernel_class(name, classes)
        by_class[c] = by_class.get(c, 0.0) + (b - a) / 1e6
    gaps = [(a, b) for (_, a), (b, _) in zip(busy, busy[1:], strict=False)]
    if busy:
        gaps = [(lo, busy[0][0])] + gaps + [(busy[-1][1], hi)]
    host.sort()
    starts = [h[0] for h in host]
    idle: dict[str, float] = {}
    for a, b in gaps:
        if b - a < SHORT_GAP_US:
            name = f"gaps under {SHORT_GAP_US} us"
        else:
            name = host_op(host, starts, (a + b) / 2)
        if b > a:
            idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    top = sorted(by_class.items(), key=lambda kv: -kv[1])[:10]
    gap_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {
        "kernels": kernels, "window_s": (hi - lo) / 1e6,
        "busy_s": busy_us / 1e6,
        "breakdown": {"device_ops": [[k, v] for k, v in top],
                      "idle_gaps": [[k, v] for k, v in gap_top]},
    }


def kernel_seconds(kernels, keys) -> tuple[int, float]:
    """(launches, device seconds) of the operations whose names hold one
    of ``keys``."""
    n, s = 0, 0.0
    for name, a, b in kernels:
        if any(k in name for k in keys):
            n += 1
            s += (b - a) / 1e6
    return n, s
