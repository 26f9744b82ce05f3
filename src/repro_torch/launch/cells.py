"""Cell builders: one traceable step per (arch x shape x mesh)
(``repro.launch.cells`` counterpart).

A *cell* bundles the port's step function, its arguments as ``meta``
tensors (shapes and dtypes, no storage), each argument leaf's sharding
spec on the mesh, and the collectives the sharded program would run —
everything :mod:`repro_torch.launch.dryrun` needs to cost the step
without allocating a single parameter.  :meth:`Cell.trace` (the
reference's ``lower().compile()``) runs the step on its arguments under
:class:`~repro_torch.analysis.op_costs.OpCounter`.

Sharding plan (the reference's baseline):

* train — worker axis per :meth:`ArchSpec.worker_axes`; tensor/expert
  parallel over ``model``; ``large`` archs FSDP over ``data``; batch
  ``[W, n_micro, B_micro, ...]`` with gradient accumulation sized so the
  per-device remat stash stays under ~2 GB;
* prefill/decode — one synchronized replica; weights over ``model``
  (+``data`` for large archs), request batch over ``data`` when
  divisible, caches by :func:`_cache_shardings`.  The ``pod`` axis of
  the multi-pod mesh holds a copy each (``Cell.replicas``), as in the
  reference, whose serving specs never name it.

Per-device argument and output bytes come from the specs and the shard
shapes (:func:`repro_torch.parallel.sharding.shard_shape`).  The traced
FLOPs and bytes are those of the whole program (every worker and
microbatch), so an artifact carries ``cost_is_per_device: false`` and
the roofline divides by the devices.  Collectives are reckoned from the
specs and the plan (:mod:`repro_torch.analysis.collectives`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from ..analysis import collectives as coll
from ..analysis.op_costs import OpCounter
from ..analysis.roofline import model_flops
from ..configs import SHAPES, ArchSpec, batch_specs, get_arch
from ..configs.shapes import ShapeSpec
from ..core import HardwareSpec, analytic_profile, build_plan
from ..core.plans import SyncPlan
from ..kernels import _cost
from ..models.layers import MetaGenerator, param_shapes
from ..optim import make_optimizer
from ..parallel.sharding import (RULES_EP2, RULES_FSDP_MODEL,
                                 param_shardings, shard_bytes)
from ..runtime.step import (StepConfig, TrainState, init_train_state,
                            make_decode_step, make_prefill_step,
                            make_train_step)
from ..tree import tree_map

__all__ = ["Cell", "build_cell", "build_train_cell", "build_prefill_cell",
           "build_decode_cell", "WAN_BANDWIDTH"]

WAN_BANDWIDTH = 1e9          # geo sync-axis bytes/s for schedule solving
_STASH_BUDGET = 2e9          # per-device remat stash target (bytes)

Tree = Any


@dataclass
class Cell:
    arch_id: str
    shape_name: str
    mesh_name: str
    kind: str                           # train | prefill | decode
    step: Callable
    args: tuple                         # meta tensors (trees)
    arg_specs: tuple                    # per-leaf specs mirroring args
    mesh: Any
    model_flops: float
    collectives: coll.CollectiveSummary
    donated: tuple[int, ...] = ()       # args the step updates in place
    replicas: int = 1                   # copies of the program the mesh runs
    meta: dict = field(default_factory=dict)
    # generator -> the arguments as real tensors on its device, the whole
    # tree on one device (a one-device mesh's cell): parameters by the
    # model's init, optimizer state and caches as the step starts them,
    # token ids and frontend inputs drawn from the generator, decode
    # positions at the cache's last slot
    materialize: Callable[[torch.Generator], tuple] | None = None

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    def arg_bytes(self) -> int:
        """Per-device bytes of every argument under its spec."""
        return sum(_tree_shard_bytes(a, s, self.mesh)
                   for a, s in zip(self.args, self.arg_specs, strict=True))

    def alias_bytes(self) -> int:
        """Per-device bytes of the arguments the step updates in place
        (the reference's donated, aliased buffers)."""
        return sum(_tree_shard_bytes(self.args[i], self.arg_specs[i],
                                     self.mesh) for i in self.donated)

    def fresh_output_bytes(self, out) -> int:
        """Bytes of the step's outputs that are not its arguments updated
        in place (logits, metrics)."""
        have = {t.untyped_storage()._cdata for t in _leaves(self.args)
                if isinstance(t, torch.Tensor)}
        return sum(t.numel() * t.element_size() for t in _leaves(out)
                   if isinstance(t, torch.Tensor)
                   and t.untyped_storage()._cdata not in have)

    def trace(self, args: tuple | None = None) -> tuple[OpCounter, Any]:
        """Run the step once under an :class:`OpCounter` — on the meta
        arguments, or on ``args`` (real tensors of the same tree) — and
        return the counter and the step's output.  The counts are the
        whole mesh's: ``replicas`` times the step's."""
        args = self.args if args is None else args
        with OpCounter() as counter, _cost.repeat(self.replicas):
            out = self.step(*args)
        return counter, out


def _is_node(tree: Tree) -> bool:
    """A NamedTuple, a list, or a tuple of tensors (a recurrent cache) is
    a node; a spec tuple (axis names) is a leaf."""
    return hasattr(tree, "_fields") or isinstance(tree, list) or (
        isinstance(tree, tuple)
        and any(isinstance(x, (torch.Tensor, dict)) for x in tree))


def _leaves(tree: Tree) -> list:
    """Leaves of a cell's argument or spec tree, dicts in sorted-key
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if _is_node(tree):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map_tensors(fn, tree: Tree) -> Tree:
    """``fn`` over a cache tree's tensors; a tuple node becomes a list,
    so a spec tree stays apart from its spec tuples."""
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if _is_node(tree):
        return [_map_tensors(fn, v) for v in tree]
    return fn(tree)


def _tree_shard_bytes(tree: Tree, specs: Tree, mesh) -> int:
    return sum(shard_bytes(t, s, mesh)
               for t, s in zip(_leaves(tree), _leaves(specs), strict=True)
               if t is not None)


def _draw(t: torch.Tensor, gen: torch.Generator, vocab: int
          ) -> torch.Tensor:
    """A real tensor like meta ``t``: token ids below ``vocab``, or
    standard normal values."""
    if t.dtype.is_floating_point:
        return torch.randn(t.shape, generator=gen, device=gen.device,
                           dtype=torch.float32).to(t.dtype)
    return torch.randint(0, vocab, t.shape, generator=gen,
                         device=gen.device, dtype=t.dtype)


def _n_layers(cfg) -> int:
    return getattr(cfg, "n_layers", None) or \
        (cfg.n_enc_layers + cfg.n_dec_layers)


def _mk_opt(arch: ArchSpec, override: str | None = None):
    name = override or arch.optimizer
    if name == "adafactor":
        return make_optimizer("adafactor", beta1=0.0, lr=1e-3)
    return make_optimizer(name, lr=3e-4)


def _plan_for(arch: ArchSpec, model, shape: ShapeSpec, w: int,
              bandwidth: float = WAN_BANDWIDTH) -> SyncPlan:
    bw_batch = max(shape.global_batch // max(w, 1), 1)
    costs = model.layer_costs(bw_batch, shape.seq_len)
    hw = HardwareSpec(bandwidth=bandwidth, n_workers=max(w, 2),
                      latency=1e-3)
    prof = analytic_profile(costs, hw)
    return build_plan("dreamddp", prof, H=5)


def _dominant_phase(plan: SyncPlan, model, shape: ShapeSpec) -> int:
    """Phase with the most synced parameter bytes (the sync-critical one)."""
    costs = model.layer_costs(1, shape.seq_len)
    best, best_b = 0, -1.0
    for h in range(plan.H):
        b = sum(costs[u][1] for u in plan.units_for_phase(h))
        if b > best_b:
            best, best_b = h, b
    return best


def _n_micro(arch: ArchSpec, model, shape: ShapeSpec, w: int, mesh) -> int:
    """Grad-accumulation factor bounding the per-device remat stash.

    For FSDP (large) archs the per-microbatch batch must stay divisible
    by the ``data`` axis, since the batch is data-sharded inside the
    worker."""
    d = model.cfg.d_model
    bw_batch = max(shape.global_batch // max(w, 1), 1)
    data_shard = mesh.shape["data"] if arch.large else 1
    b_dev = max(bw_batch // data_shard, 1)
    stash = b_dev * shape.seq_len * d * 2 * _n_layers(model.cfg)
    n = max(1, math.ceil(stash / _STASH_BUDGET))
    n = min(n, max(bw_batch // data_shard, 1))
    while bw_batch % n or (bw_batch // n) % data_shard:
        n -= 1
    return max(n, 1)


def _shard_if_divisible(mesh, n: int, axis: str = "data"):
    return axis if n % mesh.shape[axis] == 0 and n >= mesh.shape[axis] \
        else None


def _adafactor_shardings(pshard: Tree, params: Tree, min_dim: int = 8):
    """Adafactor's factored second moment: ``vr`` drops a matrix's last
    dim, ``vc`` its second last, each keeping the other dims' specs."""
    def one(spec, t):
        nd = t.dim()
        spec = tuple(spec) + (None,) * (nd - len(spec))
        if nd >= 2 and t.shape[-1] >= min_dim and t.shape[-2] >= min_dim:
            return {"vr": spec[:-1], "vc": spec[:-2] + spec[-1:]}
        return {"v": spec}
    return tree_map(one, pshard, params)


def _opt_shardings(opt_name: str, pshard: Tree, params: Tree):
    if opt_name in ("adam", "adamw"):
        return {"m": pshard, "v": pshard}
    if opt_name == "momentum":
        return {"m": pshard}
    if opt_name == "adafactor":
        return {"v": _adafactor_shardings(pshard, params), "m": None}
    return {}


def _cache_shardings(cache: Tree, mesh, *, batch: int) -> Tree:
    """Serving caches ``[n_layers, B, ...]``: batch over data when
    divisible; the largest model-divisible trailing dim over ``model``."""
    msize = mesh.shape["model"]
    dsh = _shard_if_divisible(mesh, batch, "data")

    def one(t):
        dims: list = [None] * t.dim()
        if t.dim() >= 2:
            dims[1] = dsh
        for i in range(t.dim() - 1, 1, -1):          # prefer trailing dims
            if t.shape[i] % msize == 0 and t.shape[i] >= msize:
                dims[i] = "model"
                break
        return tuple(dims)

    return _map_tensors(one, cache)


def _act_bytes(model, tokens_per_device: int) -> int:
    """One activation ``[tokens, d_model]`` in the parameter dtype."""
    cfg = model.cfg
    return tokens_per_device * cfg.d_model * cfg.dtype.itemsize


def _n_moe_layers(model) -> int:
    runs = getattr(model.cfg, "runs", None)
    return sum(n for _, kind, n in runs() if kind == "moe") if runs else 0


def _mesh_name(multi_pod: bool) -> str:
    return "multi_pod" if multi_pod else "single_pod"


# ---------------------------------------------------------------------------
# Train cells
# ---------------------------------------------------------------------------

def build_train_cell(arch: ArchSpec, shape: ShapeSpec, mesh, *,
                     multi_pod: bool, algo: str = "dreamddp",
                     phase: int | None = None,
                     step_cfg: StepConfig | None = None,
                     intra_worker: str = "tp",
                     optimizer_override: str | None = None) -> Cell:
    """``intra_worker``: how a worker's ``model``-axis devices cooperate.

    * ``"tp"`` (baseline) — Megatron tensor parallel (heads/ff/vocab over
      `model`); activations all-reduced twice per layer.
    * ``"fsdp"`` — ZeRO-3 within the worker: weights sharded over `model`
      and gathered per layer; batch sharded over `model`.
    * ``"dp"`` — weights replicated per device, batch sharded over
      `model` (each device one data-parallel rank inside the worker;
      gradients all-reduced over `model`, the DreamDDP partial sync over
      `data`); Adafactor by default, so the replicated state fits.
    * ``"ep2"`` — two-axis expert parallel (expert dim over `data` x
      `model`) for large MoE archs.
    """
    model = arch.make_model()
    if intra_worker == "dp" and optimizer_override is None:
        optimizer_override = "adafactor"   # replicated state must fit
    opt_name = optimizer_override or arch.optimizer
    opt = _mk_opt(arch, optimizer_override)
    w = arch.n_workers(multi_pod=multi_pod)
    worker_axes = arch.worker_axes(multi_pod=multi_pod)
    n_micro = _n_micro(arch, model, shape, w, mesh)
    if intra_worker in ("fsdp", "dp"):
        if arch.large:
            raise ValueError(f"{intra_worker} intra-worker mode is for "
                             "small archs")
        # batch shards over `model`: microbatching only if still too big
        if (shape.global_batch // max(w, 1)) % mesh.shape["model"]:
            raise ValueError("worker batch must divide the model axis")
        n_micro = 1
    cfg = step_cfg or StepConfig(n_microbatches=n_micro)

    if algo == "dreamddp":
        plan = _plan_for(arch, model, shape, w)
    else:
        prof = analytic_profile(model.layer_costs(1, shape.seq_len),
                                HardwareSpec(n_workers=max(w, 2)))
        plan = build_plan(algo, prof, 5)
    ph = _dominant_phase(plan, model, shape) if phase is None else phase
    step_fn = make_train_step(model, opt, plan, ph, cfg=cfg)

    # ---- arguments ----------------------------------------------------------
    state = init_train_state(model, opt, MetaGenerator(), w, cfg=cfg)
    batch = batch_specs(arch, shape, n_workers=w)
    nm = cfg.n_microbatches
    if nm > 1:
        batch = {k: v.reshape(v.shape[0], nm, v.shape[1] // nm,
                              *v.shape[2:]) for k, v in batch.items()}

    # ---- shardings ----------------------------------------------------------
    logical = model.param_specs()
    fsdp_axis = "data"
    if intra_worker == "ep2":
        pshard = param_shardings(logical, mesh, worker_axes=worker_axes,
                                 fsdp=True, rules=RULES_EP2,
                                 shapes=state.params)
    elif intra_worker == "fsdp":
        fsdp_axis = "model"
        pshard = param_shardings(logical, mesh, worker_axes=worker_axes,
                                 fsdp=True, fsdp_axis="model",
                                 rules=RULES_FSDP_MODEL, shapes=state.params)
    elif intra_worker == "dp":
        pshard = param_shardings(logical, mesh, worker_axes=worker_axes,
                                 fsdp=False, rules=RULES_FSDP_MODEL,
                                 shapes=state.params)
    else:
        pshard = param_shardings(logical, mesh, worker_axes=worker_axes,
                                 fsdp=arch.large, shapes=state.params)
    oshard = _opt_shardings(opt_name, pshard, state.params)
    state_sh = TrainState(params=pshard, opt_state=oshard, step=(),
                          ef=None, outer=None)

    lead = (worker_axes if len(worker_axes) != 1 else worker_axes[0]) \
        if worker_axes else None
    data_left = "data" if arch.large else \
        ("model" if intra_worker in ("fsdp", "dp") else None)
    extra = (None,) if nm > 1 else ()
    batch_sh = {k: (lead, *extra, data_left,
                    *(None,) * (v.dim() - 2 - len(extra)))
                for k, v in batch.items()}

    # ---- collectives --------------------------------------------------------
    ops = coll.CollectiveSummary()
    group_w = coll.group_size(mesh, worker_axes)
    units = plan.units_for_phase(ph)
    if plan.is_parameter_sync:
        coll.partial_sync_ops(ops, state.params, pshard, mesh,
                              model.unit_layout(), units, group_w)
    else:
        coll.grad_sync_ops(ops, state.params, pshard, mesh, group_w)
    bw_batch = shape.global_batch // max(w, 1)
    data_shard = mesh.shape["data"] if arch.large else \
        (mesh.shape["model"] if intra_worker in ("fsdp", "dp") else 1)
    tokens_dev = max(bw_batch // nm // data_shard, 1) * shape.seq_len
    msize = mesh.shape["model"]
    if intra_worker in ("tp", "ep2"):
        coll.tp_ops(ops, n_layers=_n_layers(model.cfg), n_micro=nm,
                    act_bytes=_act_bytes(model, tokens_dev), group=msize,
                    backward=True)
    if arch.large or intra_worker in ("fsdp", "ep2"):
        coll.fsdp_ops(ops, state.params, pshard, logical, mesh, fsdp_axis,
                      n_micro=nm, backward=True, lead=True)
    if intra_worker == "dp":
        coll.grad_sync_ops(ops, state.params, pshard, mesh, msize,
                           dtype_bytes=None)
    if intra_worker == "ep2" and _n_moe_layers(model):
        coll.moe_a2a_ops(ops, n_moe_layers=_n_moe_layers(model),
                         n_micro=nm,
                         token_bytes=_act_bytes(model, tokens_dev)
                         * model.cfg.moe.top_k,
                         group=mesh.shape["data"] * msize, backward=True)

    def make_args(gen):
        real = init_train_state(model, opt, gen, w, cfg=cfg)
        return real, {k: _draw(v, gen, model.cfg.vocab)
                      for k, v in batch.items()}

    tokens = shape.global_batch * shape.seq_len
    return Cell(
        arch_id=arch.arch_id, shape_name=shape.name,
        mesh_name=_mesh_name(multi_pod), kind="train", step=step_fn,
        args=(state, batch), arg_specs=(state_sh, batch_sh), mesh=mesh,
        model_flops=model_flops(model.active_param_count(), tokens,
                                training=True),
        collectives=ops, donated=(0,),
        meta={"algo": algo, "phase": ph, "n_workers": w,
              "n_microbatches": nm, "intra_worker": intra_worker,
              "plan_counts": plan.meta.get("partition_counts"),
              "synced_units": list(units),
              "plan_fingerprint": plan.fingerprint()},
        materialize=make_args,
    )


# ---------------------------------------------------------------------------
# Serve cells
# ---------------------------------------------------------------------------

def _serve_args(arch: ArchSpec, model, shape: ShapeSpec, mesh):
    """(params, their specs, cache, its specs, the request batch's spec
    entry, the collectives) of a prefill or decode cell."""
    b, s = shape.global_batch, shape.seq_len
    params = param_shapes(model)
    logical = model.param_specs()
    pshard = param_shardings(logical, mesh, worker_axes=(),
                             fsdp=arch.large, with_lead=False, shapes=params)
    cache = model.init_cache(b, s, device="meta")
    cshard = _cache_shardings(cache, mesh, batch=b)
    dsh = _shard_if_divisible(mesh, b)
    ops = coll.CollectiveSummary()
    q_len = s if shape.kind == "prefill" else 1
    b_dev = b // mesh.shape["data"] if dsh else b
    coll.tp_ops(ops, n_layers=_n_layers(model.cfg), n_micro=1,
                act_bytes=_act_bytes(model, b_dev * q_len),
                group=mesh.shape["model"], backward=False)
    if arch.large:
        coll.fsdp_ops(ops, params, pshard, logical, mesh, "data",
                      n_micro=1, backward=False, lead=False)
    return params, pshard, cache, cshard, dsh, ops


def _serve_replicas(mesh) -> int:
    """Serving specs name ``data`` and ``model`` only: every other axis
    holds copies."""
    return mesh.size // (mesh.shape["data"] * mesh.shape["model"])


def build_prefill_cell(arch: ArchSpec, shape: ShapeSpec, mesh, *,
                       multi_pod: bool) -> Cell:
    model = arch.make_model()
    b, s = shape.global_batch, shape.seq_len
    params, pshard, cache, cshard, dsh, ops = _serve_args(arch, model,
                                                          shape, mesh)
    bspec = batch_specs(arch, shape)
    args = [params, bspec["tokens"], cache]
    specs = [pshard, (dsh, None), cshard]
    extra = {"audio": "frames", "vision": "embeds"}.get(arch.frontend)
    if extra:
        args.append(bspec[extra])
        specs.append((dsh, None, None))

    def make_args(gen):
        vocab = model.cfg.vocab
        return (model.init(gen), _draw(args[1], gen, vocab),
                model.init_cache(b, s, device=gen.device),
                *(_draw(t, gen, vocab) for t in args[3:]))

    return Cell(
        arch_id=arch.arch_id, shape_name=shape.name,
        mesh_name=_mesh_name(multi_pod), kind="prefill",
        step=make_prefill_step(model, with_frontend=arch.frontend),
        args=tuple(args), arg_specs=tuple(specs), mesh=mesh,
        model_flops=model_flops(model.active_param_count(), b * s,
                                training=False),
        collectives=ops, donated=(2,), replicas=_serve_replicas(mesh),
        meta={}, materialize=make_args,
    )


def build_decode_cell(arch: ArchSpec, shape: ShapeSpec, mesh, *,
                      multi_pod: bool) -> Cell:
    model = arch.make_model()
    b, s = shape.global_batch, shape.seq_len
    params, pshard, cache, cshard, dsh, ops = _serve_args(arch, model,
                                                          shape, mesh)
    bspec = batch_specs(arch, shape)

    def make_args(gen):
        return (model.init(gen), model.init_cache(b, s, device=gen.device),
                _draw(bspec["token"], gen, model.cfg.vocab),
                torch.full((b,), s - 1, dtype=torch.int32,
                           device=gen.device))

    return Cell(
        arch_id=arch.arch_id, shape_name=shape.name,
        mesh_name=_mesh_name(multi_pod), kind="decode",
        step=make_decode_step(model),
        args=(params, cache, bspec["token"], bspec["pos"]),
        arg_specs=(pshard, cshard, (dsh, None), (dsh,)), mesh=mesh,
        model_flops=model_flops(model.active_param_count(), b,
                                training=False),
        collectives=ops, donated=(1,), replicas=_serve_replicas(mesh),
        meta={"kv_depth": s}, materialize=make_args,
    )


def build_cell(arch_id: str, shape_name: str, mesh, *, multi_pod: bool,
               **kw) -> Cell:
    arch = get_arch(arch_id)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return build_train_cell(arch, shape, mesh, multi_pod=multi_pod,
                                **kw)
    for k in ("intra_worker", "algo", "phase"):
        kw.pop(k, None)
    if shape.kind == "prefill":
        return build_prefill_cell(arch, shape, mesh, multi_pod=multi_pod,
                                  **kw)
    return build_decode_cell(arch, shape, mesh, multi_pod=multi_pod, **kw)
