"""What each hand-written kernel costs, and how a cost counter hears of
it (:class:`repro_torch.analysis.op_costs.OpCounter`).

Called with ``impl=None`` on ``meta`` tensors, a wrapper launches
nothing and allocates nothing: it returns empty ``meta`` outputs of the
right shapes and reports its kernel as one op, with the FLOPs and bytes
of the formulas ``chip_smoke.py`` uses for each kernel's bound.  Work
that depends on data (a paged slot's ``kv_len``) is counted at its most,
since a meta tensor has none.  On the CPU a wrapper runs its plain
version inside :func:`plain_scope`, so a counter can tell which matmuls
the plain version did.  With no counter active both are no-ops.
"""

from __future__ import annotations

import contextlib

__all__ = ["KernelCost", "report", "plain_scope", "repeat", "tracing",
           "counters"]

# the active counters, innermost last
counters: list = []


class KernelCost:
    """One kernel call: ``dot_flops`` are its matrix-product FLOPs (what
    the dry run's ``flops`` counts), ``flops`` all its arithmetic,
    ``nbytes`` each input read once and each output written once."""

    __slots__ = ("name", "dot_flops", "flops", "nbytes")

    def __init__(self, name: str, dot_flops: float, flops: float,
                 nbytes: float):
        self.name, self.dot_flops = name, float(dot_flops)
        self.flops, self.nbytes = float(flops), float(nbytes)


def report(cost: KernelCost) -> None:
    """A wrapper's call on meta tensors, as one op."""
    for c in counters:
        c.kernel(cost)


@contextlib.contextmanager
def plain_scope(name: str):
    """The plain version of kernel ``name`` runs inside."""
    if not counters:
        yield
        return
    for c in counters:
        c.enter_plain(name)
    try:
        yield
    finally:
        for c in counters:
            c.exit_plain(name)


def tracing(t) -> bool:
    """A counter is active and ``t`` is a ``meta`` tensor (a dry-run
    trace)."""
    return bool(counters) and t.is_meta


@contextlib.contextmanager
def repeat(n: int):
    """The ops inside stand for ``n`` identical executions (the
    reference's loop trip count): counters count each ``n`` times."""
    for c in counters:
        c.enter_repeat(n)
    try:
        yield
    finally:
        for c in counters:
            c.exit_repeat(n)


def causal_pairs(sq: int, sk: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs a flash launch computes: query row ``r`` (from
    0) sees keys ``<= r`` when causal, the last ``window`` of them with a
    window, every key otherwise."""
    if not causal:
        return sq * sk
    w = min(window or sk, sk)
    if sq <= w:
        return sq * (sq + 1) // 2
    return w * (w + 1) // 2 + (sq - w) * w
