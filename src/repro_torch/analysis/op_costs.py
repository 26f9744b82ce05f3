"""Executed-cost counter over a traced step (``repro.analysis.hlo_costs``
counterpart).

The reference compiles each cell and parses the optimized HLO.  The port
runs the step instead, under :class:`OpCounter`, a ``TorchDispatchMode``
that sees every aten op the step executes — on ``meta`` tensors for the
production cells, so nothing is computed or allocated, or on real ones.
Every executed op is counted once per execution, so there are no loops
of unknown trip count (``unknown_loops`` is always 0).

* FLOPs: matrix products only, as the reference's ``_dot_flops`` counts
  ``dot`` instructions: ``mm``, ``addmm``, ``bmm``, ``baddbmm`` and
  ``_scaled_mm``, by ``torch.utils.flop_counter``'s formulas (``2 m n
  k``).  ``n_dots`` is the number of such ops executed (the reference
  counts dot instructions in the module text).
* Bytes: each costed op's tensor inputs and outputs, once per execution.
  The costed ops map the reference's ``_COSTED_OPS`` (matmuls,
  convolutions, copies, gathers and scatters, reductions, sorts,
  selects, pads and concatenations, :data:`COSTED_OPS`); a view moves no
  bytes and **bare elementwise ops are not charged**, the reference's
  proxy for what a fused program keeps out of memory.
* Hand-written kernels: a wrapper called on ``meta`` tensors reports its
  kernel as one op (:mod:`repro_torch.kernels._cost`), with its
  matrix-product FLOPs and its bytes, so a meta trace follows the
  program the card runs (one flash launch, not the plain attention's
  score matrix).  On the CPU the plain versions run, and the matmuls
  they do are also kept apart by kernel (``plain_dot_flops``).
* Loops: code that runs identical iterations on ``meta`` tensors (the
  training step's workers and microbatches) may trace one iteration
  inside :func:`repro_torch.kernels._cost.repeat`, which counts it as
  many times over — the reference's loop body times its trip count.
* Memory: every storage an op creates is tracked until it is freed;
  ``peak_bytes`` is the most that was live at once beyond the storages
  that existed before the counter started (the arguments).  It is an
  estimate of the step's temporary memory on one device running the
  whole traced program.
"""

from __future__ import annotations

import collections
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels import _cost
from .collectives import CollectiveSummary

__all__ = ["ModuleCosts", "OpCounter", "COSTED_OPS", "MATMUL_OPS"]

aten = torch.ops.aten

MATMUL_OPS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten._scaled_mm}

# the reference's costed HLO opcodes, as aten ops:
#   dot, convolution -> the matmuls, convolution(_backward)
#   copy, transpose  -> copy_, clone, _to_copy (a transpose is a view
#                       until something copies it)
#   dynamic-slice, gather, slice -> index, index_select, gather, embedding
#   dynamic-update-slice, scatter -> index_put, scatter, index_add,
#                       slice_scatter, embedding_dense_backward
#   reduce, reduce-window -> the reductions, (log_)softmax and its
#                       backward, the NLL loss, cumulative sums
#   sort -> sort, topk;  select -> where;  pad -> constant_pad_nd;
#   concatenate -> cat, stack
COSTED_OPS = MATMUL_OPS | {
    aten.convolution, aten.convolution_backward,
    aten.copy_, aten.clone, aten._to_copy,
    aten.index, aten.index_select, aten.gather, aten.embedding,
    aten.index_put, aten.index_put_, aten._index_put_impl_, aten.scatter,
    aten.scatter_, aten.scatter_add, aten.scatter_add_, aten.index_add,
    aten.index_add_, aten.slice_scatter, aten.select_scatter,
    aten.embedding_dense_backward, aten.masked_fill, aten.masked_fill_,
    aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min,
    aten.prod, aten.argmax, aten.argmin, aten.logsumexp, aten.cumsum,
    aten.var_mean, aten.linalg_vector_norm, aten.norm,
    aten._softmax, aten._log_softmax, aten._softmax_backward_data,
    aten._log_softmax_backward_data, aten.nll_loss_forward,
    aten.nll_loss_backward, aten.sort, aten.topk, aten.where,
    aten.constant_pad_nd, aten.cat, aten.stack,
}


@dataclass
class ModuleCosts:
    """The reference's ``ModuleCosts``, from a traced step."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    collectives: CollectiveSummary = field(
        default_factory=CollectiveSummary)
    n_dots: int = 0
    unknown_loops: int = 0

    def to_dict(self) -> dict:
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "n_dots": self.n_dots, "unknown_loops": self.unknown_loops,
                "collectives": self.collectives.to_dict()}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts the aten ops a step executes (see the module docstring).

    ``table`` maps an op's name to ``[calls, flops, bytes, dots]``
    (``dots``: the calls counted in ``n_dots``): aten ops by
    overload packet, a kernel reported on meta tensors as
    ``kernel:<name>``.  ``kernels`` keeps each kernel's calls, matrix
    FLOPs, all its FLOPs and bytes; ``plain_dot_flops`` the matmul FLOPs
    each kernel's plain version did on real tensors.
    """

    def __init__(self):
        super().__init__()
        self.costs = ModuleCosts()
        self.table: dict[str, list] = collections.defaultdict(
            lambda: [0, 0.0, 0.0, 0])
        self.kernels: dict[str, list] = collections.defaultdict(
            lambda: [0, 0.0, 0.0, 0.0])
        self.plain_dot_flops: dict[str, float] = collections.defaultdict(
            float)
        self._plain: list[str] = []
        self._mult = 1                          # product of repeat scopes
        self._live: dict[int, int] = {}         # storage id -> bytes
        self.live_bytes = 0
        self.peak_bytes = 0

    # ---------------------------------------------------------- scopes
    def __enter__(self):
        _cost.counters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _cost.counters.remove(self)
        return super().__exit__(*exc)

    def enter_plain(self, name: str) -> None:
        self._plain.append(name)

    def exit_plain(self, name: str) -> None:
        self._plain.pop()

    def enter_repeat(self, n: int) -> None:
        self._mult *= n

    def exit_repeat(self, n: int) -> None:
        self._mult //= n

    # ---------------------------------------------------------- memory
    def _freed(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, ins: list[torch.Tensor],
               outs: list[torch.Tensor]) -> None:
        """Register the storages ``outs`` allocated: a storage an input
        shares (a view, an in-place op) or one already tracked is not
        new, so storages from before the counter started never count."""
        have = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in have or key in self._live:
                continue
            self._live[key] = st.nbytes()
            self.live_bytes += st.nbytes()
            weakref.finalize(st, self._freed, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    # ---------------------------------------------------------- counting
    def kernel(self, cost: _cost.KernelCost) -> None:
        """A kernel's call on meta tensors, as one op."""
        m = self._mult
        row = self.kernels[cost.name]
        row[0] += m
        row[1] += cost.dot_flops * m
        row[2] += cost.flops * m
        row[3] += cost.nbytes * m
        dots = int(cost.dot_flops > 0)
        self._count("kernel:" + cost.name, cost.dot_flops, cost.nbytes,
                    dots)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if outs:
            self._track(ins, outs)
        if packet not in COSTED_OPS:
            return out
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        flops, dots = 0.0, 0
        if packet in MATMUL_OPS:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
            dots = 1
            if self._plain:
                self.plain_dot_flops[self._plain[-1]] += flops * self._mult
        self._count(str(packet), flops, nbytes, dots)
        return out

    def _count(self, name: str, flops: float, nbytes: float,
               dots: int) -> None:
        m = self._mult
        row = self.table[name]
        row[0] += m
        row[1] += flops * m
        row[2] += nbytes * m
        row[3] += dots * m
        self.costs.flops += flops * m
        self.costs.bytes_accessed += nbytes * m
        self.costs.n_dots += dots * m
