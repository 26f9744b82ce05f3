"""Phase-specialized train steps and serve-side step functions
(``repro.runtime.step`` counterpart).

**Training.**  One step function per phase of the synchronization
period: the phase's unit set is fixed when the step is built.  The
plan's ``comm`` says whether gradients are worker-averaged before the
optimizer (classic DDP) or the phase's layer units are
parameter-averaged after the local update (Eq. 5); the *how* of each
parameter sync is the resolved :class:`SyncPolicy`.

The reference vmaps ``value_and_grad`` over the worker axis.  The port
runs a Python loop over the W workers with ordinary autograd instead of
``torch.func.vmap(grad)``: each worker's activations are freed before
the next worker starts, so activation memory is that of one worker (a
vmapped step would hold all W at once — at full width that is what does
not fit), and every model op stays an ordinary eager op.  Each worker's
gradients are written into one worker-stacked buffer, so the optimizer
and the syncs see ``[W, ...]`` leaves as in the reference.

Steps update the state **in place** (parameters, optimizer state, EF
residuals, the step counter) and return it; the counter, the learning
rate and the loss stay on the device, so a step reads nothing back to
the host, and a CUDA graph that captured a step replays it on the same
tensors.  :func:`make_period_step` composes a whole period's phase
bodies into the one function the runner's ``compiled`` mode captures.
The optimizer update and the syncs run in ``torch.profiler`` ranges
(``repro_torch.optimizer``, ``repro_torch.sync``), so a profile can
charge device time to them.

**Serving.**  The reference builds jitted closures
(``make_slot_prefill_step`` and friends) and vmaps single-lane steps over
the slot axis.  PyTorch runs eagerly, so these are plain functions, and
the model's own steps already take a write position per lane.  Cache
leaves are ``[layers, lanes, ...]``; a slot is one lane of axis 1.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple

import torch
from torch.profiler import record_function

from ..core.outer_opt import OuterConfig, OuterState
from ..core.partial_sync import (UnitLayout, contiguous_ranges, divergence,
                                 sync_units, tree_worker_mean, worker_stack)
from ..core.plans import SyncPlan, local_plan
from ..core.sync_policies import SyncPolicy, resolve_policy
from ..tree import tree_leaves, tree_map

__all__ = ["TrainState", "StepConfig", "init_train_state",
           "per_worker_grads", "make_train_step", "make_phase_steps",
           "compose_makeup_step", "make_period_step",
           "slot_prefill", "slot_decode", "slot_decode_paged"]

Tree = Any


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    params: Tree                      # worker-stacked [W, ...]
    opt_state: Tree
    step: torch.Tensor                # int32 scalar on the device
    ef: Tree | None = None            # int8 error-feedback residuals
    outer: OuterState | None = None   # DiLoCo outer state


@dataclass(frozen=True)
class StepConfig:
    n_microbatches: int = 1
    policy: SyncPolicy | None = None  # explicit sync policy (wins)
    compress: str | None = None       # legacy flag: None | "int8_ef"
    outer: bool = False               # legacy flag: DiLoCo outer optimizer
    outer_cfg: OuterConfig = field(default_factory=OuterConfig)
    track_divergence: bool = False
    segment_cuts: bool = True         # passed to model.loss (no effect)


def init_train_state(model, optimizer, generator: torch.Generator,
                     n_workers: int, *, cfg: StepConfig = StepConfig(),
                     params: Tree | None = None) -> TrainState:
    """Identical initial replicas (workers start at a sync point), on
    ``generator``'s device: ``model.init(generator)``, or copies of
    ``params`` (an unstacked tree, e.g. the JAX package's parameters
    through ``repro_torch.convert.params_from_numpy``)."""
    if params is None:
        params = model.init(generator)
    params = worker_stack(tree_map(lambda x: x.to(generator.device),
                                   params), n_workers)
    opt_state = optimizer.init(params)
    ef, outer = resolve_policy(cfg).init_state(params)
    step = torch.zeros((), dtype=torch.int32, device=generator.device)
    return TrainState(params, opt_state, step, ef, outer)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def _cuts_for(units, layout: UnitLayout) -> tuple[int, ...]:
    """Segment-cut unit ids: boundaries of the synced intervals."""
    cuts = set()
    for lo, hi in contiguous_ranges(list(units)):
        cuts.add(lo)
        cuts.add(hi)
    return tuple(sorted(cuts))


def per_worker_grads(model, params: Tree, batch: dict, *,
                     segment_cuts: tuple[int, ...] = (),
                     n_microbatches: int = 1
                     ) -> tuple[torch.Tensor, Tree]:
    """Per-worker loss and gradients of a worker-stacked tree.

    ``batch`` leaves are ``[W, B, ...]``, or ``[W, n_micro, B_micro,
    ...]`` with ``n_microbatches > 1`` (gradients then accumulate in
    float32, as in the reference).  Returns (losses ``[W]`` float32,
    worker-stacked gradients in the parameter dtype, float32 when
    accumulated).
    """
    leaves = tree_leaves(params)
    n_workers = leaves[0].shape[0]
    gdtype = None if n_microbatches == 1 else torch.float32
    grads = tree_map(lambda x: torch.empty(x.shape, dtype=gdtype or x.dtype,
                                           device=x.device), params)
    grad_leaves = tree_leaves(grads)
    losses = []
    for k in range(n_workers):
        pk = tree_map(lambda x: x[k].detach().requires_grad_(), params)
        pk_leaves = tree_leaves(pk)
        if n_microbatches == 1:
            loss = model.loss(pk, {n: v[k] for n, v in batch.items()},
                              segment_cuts=segment_cuts)
            for buf, g in zip(grad_leaves, torch.autograd.grad(loss,
                                                               pk_leaves),
                              strict=True):
                buf[k].copy_(g)
            losses.append(loss.detach().float())
            continue
        total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for buf in grad_leaves:
            buf[k].zero_()
        for j in range(n_microbatches):
            loss = model.loss(pk, {n: v[k, j] for n, v in batch.items()},
                              segment_cuts=segment_cuts)
            for buf, g in zip(grad_leaves, torch.autograd.grad(loss,
                                                               pk_leaves),
                              strict=True):
                buf[k].add_(g)
            total = total + loss.detach().float()
        inv = 1.0 / n_microbatches
        for buf in grad_leaves:
            buf[k].mul_(inv)
        losses.append(total * inv)
    return torch.stack(losses), grads


def make_train_step(model, optimizer, plan: SyncPlan, phase: int, *,
                    cfg: StepConfig = StepConfig()):
    """The step for one phase (its unit set fixed at build time)."""
    layout = model.unit_layout()
    units = plan.units_for_phase(phase)
    cuts = _cuts_for(units, layout) if cfg.segment_cuts else ()
    policy = resolve_policy(cfg)

    def train_step(state: TrainState, batch: dict
                   ) -> tuple[TrainState, dict]:
        losses, grads = per_worker_grads(
            model, state.params, batch, segment_cuts=cuts,
            n_microbatches=cfg.n_microbatches)
        metrics = {"loss": losses.mean()}

        if not plan.is_parameter_sync:           # DDP: gradient all-reduce
            with record_function("repro_torch.sync"):
                grads = tree_worker_mean(grads)
        with record_function("repro_torch.optimizer"):
            params, opt_state = optimizer.update(grads, state.opt_state,
                                                 state.params, state.step)
        del grads
        ef, outer = state.ef, state.outer
        if plan.is_parameter_sync and units:
            with record_function("repro_torch.sync"):
                params, ef, outer = policy.apply(params, ef, outer, units,
                                                 layout)
        if cfg.track_divergence:
            metrics["divergence"] = divergence(params)
        state.step.add_(1)
        return TrainState(params, opt_state, state.step, ef, outer), metrics

    return train_step


def make_phase_steps(model, optimizer, plan: SyncPlan, *,
                     cfg: StepConfig = StepConfig()):
    """One step function per phase of the period."""
    return [make_train_step(model, optimizer, plan, h, cfg=cfg)
            for h in range(plan.H)]


def compose_makeup_step(local_step, units, layout: UnitLayout):
    """Straggler make-up body: a pure local step followed by an extra
    sync of exactly ``units`` — the ONE definition of make-up semantics,
    shared by the runner's per-step and fused paths."""
    units = tuple(sorted(units))

    def makeup(state: TrainState, batch: dict):
        new_state, m = local_step(state, batch)
        sync_units(new_state.params, list(units), layout)
        return new_state, m

    return makeup


def make_period_step(model, optimizer, plan: SyncPlan, *,
                     cfg: StepConfig = StepConfig(),
                     makeup_units: tuple[int, ...] = ()):
    """All ``H`` phase steps of ``plan`` as one function (the
    reference's one jitted period program).

    ``batch`` leaves carry a leading phase axis (``{tokens: [H, W, B,
    S], ...}``).  Consecutive phases with one unit set
    (``plan.phase_segments()``) share one body, run once per phase on
    its slice of the batch; the bodies are the per-step path's own, so
    a period gives that path's states bitwise.  ``makeup_units``
    (straggler make-up at a period boundary) makes phase 0 the make-up
    body (:func:`compose_makeup_step`).  Returns the state, updated in
    place, and the metrics stacked ``[H]`` on the device.
    """
    layout = model.unit_layout()
    segments = list(plan.phase_segments())
    if makeup_units:
        # phase 0 gets its own body; split it out of its segment
        _, l0 = segments[0]
        segments = [(0, 1)] + ([(1, l0 - 1)] if l0 > 1 else []) \
            + segments[1:]
    bodies = {}
    for start, _ in segments:
        if start == 0 and makeup_units:
            local = make_train_step(model, optimizer,
                                    local_plan(plan.n_units), 0, cfg=cfg)
            bodies[0] = compose_makeup_step(local, makeup_units, layout)
        else:
            bodies[start] = make_train_step(model, optimizer, plan, start,
                                            cfg=cfg)

    def period_step(state: TrainState, batch: dict
                    ) -> tuple[TrainState, dict]:
        metrics = []
        for start, length in segments:
            for h in range(start, start + length):
                state, m = bodies[start](state, {k: v[h] for k, v in
                                                 batch.items()})
                metrics.append(m)
        return state, {k: torch.stack([m[k] for m in metrics])
                       for k in metrics[0]}

    return period_step


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------


def slot_prefill(model, params, tokens: torch.Tensor, depth: int,
                 refeed: tuple[torch.Tensor, torch.Tensor] | None = None
                 ) -> tuple[torch.Tensor, Tree]:
    """Prefill K same-length requests into K fresh cache lanes.

    ``tokens [K, S]`` (one row per request, all padded to one bucket
    length; K = 1 is the serial path); the lanes are ``depth >= S``
    deep and every lane writes from position 0, the model's native
    prefill contract.  With ``refeed = (tok [K], pos [K])`` the last
    prompt token of each lane is decoded again at its own position —
    after a right-padded prefill the last logits belong to a pad, and
    this recovers the true ones (it rewrites the identical KV entry and
    attends the same causal window).  Returns (logits ``[K, V]``, lanes)
    for the caller to commit into its pool.
    """
    lanes = model.init_cache(tokens.shape[0], depth, device=tokens.device)
    logits, lanes = model.prefill(params, tokens, lanes)
    if refeed is not None:
        tok, pos = refeed
        logits, lanes = model.decode_step(params, lanes, tok[:, None], pos)
    return logits[:, 0], lanes


def slot_decode(model, params, arena: Tree, tokens: torch.Tensor,
                pos: torch.Tensor, *, attn_scratch=None) -> torch.Tensor:
    """One decode tick over every lane of a contiguous arena, each lane
    at its own position (``tokens [S]``, ``pos [S]``) -> logits ``[S,
    V]``.  The arena is updated in place.  ``attn_scratch`` (the paged
    kernel's split-K scratch of the caller's own) goes to a model whose
    contiguous decode runs that kernel (the Griffin hybrid's rings)."""
    kw = {} if attn_scratch is None else {"attn_scratch": attn_scratch}
    logits, _ = model.decode_step(params, arena, tokens[:, None], pos, **kw)
    return logits[:, 0]


def slot_decode_paged(model, params, pages: Tree, tokens: torch.Tensor,
                      pos: torch.Tensor, block_tables: torch.Tensor,
                      active: torch.Tensor, *, attn_scratch=None
                      ) -> torch.Tensor:
    """One decode tick against the paged pool: ``block_tables [S,
    max_blocks]`` route the KV traffic and ``active [S]`` parks inactive
    lanes' writes on the trash page (``attn_scratch``: the paged
    kernel's split-K scratch of the caller's own).  -> logits ``[S,
    V]``; the pool is updated in place."""
    logits, _ = model.decode_step_paged(params, pages, tokens[:, None], pos,
                                        block_tables, active,
                                        attn_scratch=attn_scratch)
    return logits[:, 0]
