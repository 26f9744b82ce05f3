"""The port's production dry run against the JAX package's logic.

Everything the dry run derives without tracing is held exactly to the
reference: the shapes, every ``ArchSpec`` field (the factories and the
free-text ``notes`` aside), ``batch_specs``, ``param_specs()`` and the
parameter shapes of all 10 archs at published widths, every case of
``tests/test_sharding.py`` and every leaf's spec under each rule table
on both production meshes (the reference's ``leaf_spec`` on a fake mesh,
as ``tests/test_sharding.py`` does), the per-device argument bytes of
every cell (summed here from the reference's specs and
``jax.eval_shape`` shapes), every train cell's plan and meta (the
reference's ``_plan_for``, ``_dominant_phase`` and ``_n_micro`` on a
fake mesh), ``model_flops``, the V5E roofline and the ring factors.
The CLI writes the reference's artifact keys and ``reanalyze`` gives
back its sums.  No trace of a production cell runs here but one decode
cell through the CLI (~2 s).
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.analysis import hlo as jhlo  # noqa: E402
from repro.analysis import roofline as jroof  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import all_cells as jall_cells  # noqa: E402
from repro.configs import batch_specs as jbatch_specs  # noqa: E402
from repro.launch import cells as jcells  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.parallel import compression as jcomp  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch.analysis import collectives as coll  # noqa: E402
from repro_torch.analysis import roofline as troof  # noqa: E402
from repro_torch.analysis.reanalyze import reanalyze  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPES, all_cells,  # noqa: E402
                                 batch_specs)
from repro_torch.launch import cells, dryrun  # noqa: E402
from repro_torch.launch.mesh import (MULTI_POD, SINGLE_POD,  # noqa: E402
                                     MeshSpec, make_production_mesh)
from repro_torch.models.layers import param_shapes  # noqa: E402
from repro_torch.parallel import EFState, ef_init  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

MESHES = {False: make_production_mesh(multi_pod=False),
          True: make_production_mesh(multi_pod=True)}
RULE_TABLES = {"tp": jsh.RULES, "fsdp_model": jsh.RULES_FSDP_MODEL,
               "ep2": jsh.RULES_EP2}
PORT_RULES = {"tp": tsh.RULES, "fsdp_model": tsh.RULES_FSDP_MODEL,
              "ep2": tsh.RULES_EP2}
_CACHE: dict = {}


class _FakeMesh:
    """The reference's leaf specs need only the axis sizes."""

    def __init__(self, mesh: MeshSpec):
        self.shape = mesh.shape


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _spec(p) -> tuple:
    return tuple(p)


def _jax_shapes(arch_id):
    """The reference model's param shapes and specs (cached: the
    reference's ``eval_shape`` of a full-width init takes ~0.5 s)."""
    if arch_id not in _CACHE:
        m = JARCHS[arch_id].make_model()
        _CACHE[arch_id] = (m, jax.eval_shape(m.init, jax.random.PRNGKey(0)),
                           m.param_specs())
    return _CACHE[arch_id]


def _jflat_specs(specs):
    return _flat(jax.tree.map(lambda s: tuple(s), specs,
                              is_leaf=lambda x: isinstance(x, tuple)))


# ---------------------------------------------------------------- configs

def test_shapes_and_meshes():
    assert SHAPES == {k: type(SHAPES[k])(**vars(v))
                      for k, v in JSHAPES.items()}
    assert SINGLE_POD == jmesh.SINGLE_POD and MULTI_POD == jmesh.MULTI_POD
    for mp, spec in ((False, jmesh.SINGLE_POD), (True, jmesh.MULTI_POD)):
        mesh = make_production_mesh(multi_pod=mp)
        assert mesh.shape == dict(zip(spec["axes"], spec["shape"]))
        assert mesh.size == math.prod(spec["shape"])
    assert all_cells() == jall_cells() and len(all_cells()) == 32


@pytest.mark.parametrize("arch_id", sorted(JARCHS))
def test_arch_fields(arch_id):
    a, j = ARCHS[arch_id], JARCHS[arch_id]
    for f in ("arch_id", "family", "large", "optimizer", "sub_quadratic",
              "frontend", "n_frontend_tokens"):
        assert getattr(a, f) == getattr(j, f), f
    assert [s.name for s in a.shapes()] == [s.name for s in j.shapes()]
    for mp in (False, True):
        assert a.n_workers(multi_pod=mp) == j.n_workers(multi_pod=mp)
        assert a.worker_axes(multi_pod=mp) == j.worker_axes(multi_pod=mp)
    # batch specs for every shape at W = 1 and both meshes' W
    for s in a.shapes():
        for w in {1, a.n_workers(multi_pod=False),
                  a.n_workers(multi_pod=True)}:
            got = batch_specs(a, s, n_workers=w)
            want = jbatch_specs(j, JSHAPES[s.name], n_workers=w)
            assert list(got) == list(want)
            for k in want:
                assert tuple(got[k].shape) == want[k].shape, (s.name, k)
                assert str(got[k].dtype).removeprefix("torch.") \
                    == str(want[k].dtype)


@pytest.mark.parametrize("arch_id", sorted(JARCHS))
def test_param_specs_and_shapes(arch_id):
    """``param_specs()`` and the meta parameter tree mirror the reference
    leaf for leaf, at published widths."""
    _, jshapes, jspecs = _jax_shapes(arch_id)
    model = ARCHS[arch_id].make_model()
    assert _flat(model.param_specs()) == _jflat_specs(jspecs)
    got = _flat(tree_map(lambda t: (tuple(t.shape), str(t.dtype)
                                    .removeprefix("torch.")),
                         param_shapes(model)))
    want = _flat(jax.tree.map(lambda s: (s.shape, str(s.dtype)), jshapes))
    assert got == want
    assert all(t.is_meta for t in _flat(param_shapes(model)).values())


# ---------------------------------------------------------------- sharding

class _TestMesh:
    shape = {"pod": 2, "data": 16, "model": 16}


SHARDING_CASES = [
    # tests/test_sharding.py, case by case
    (("basic_tp", (None, "heads")), dict(worker_axes=("data",))),
    (("basic_tp", ("ff", None)), dict(worker_axes=())),
    (("moe_dedup", ("layers", "expert", None, "ff")), dict(worker_axes=())),
    (("fsdp_first_free", ("layers", None, "heads")),
     dict(worker_axes=("pod",), fsdp=True)),
    (("fsdp_skips", (None, "heads")),
     dict(worker_axes=("pod", "data"), fsdp=True)),
    (("divisible_no", ("vocab", None)),
     dict(worker_axes=(), with_lead=False, shape=(50280, 1536),
          mesh=_TestMesh())),
    (("divisible_yes", ("vocab", None)),
     dict(worker_axes=(), with_lead=False, shape=(49152, 1536),
          mesh=_TestMesh())),
    (("divisible_lead", ("vocab", None)),
     dict(worker_axes=("data",), shape=(16, 50280, 1536),
          mesh=_TestMesh())),
    (("serving_no_lead", (None, "heads")),
     dict(worker_axes=(), with_lead=False)),
]


@pytest.mark.parametrize("case,kw", SHARDING_CASES,
                         ids=[c[0][0] for c in SHARDING_CASES])
def test_sharding_cases(case, kw):
    _, logical = case
    assert tsh.leaf_spec(logical, **kw) == _spec(jsh.leaf_spec(logical,
                                                               **kw))


def test_batch_and_cache_shardings():
    """``batch_shardings`` / ``cache_shardings`` / ``named`` give the
    reference's specs (a one-device mesh with the production axes)."""
    jm = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    mesh = MeshSpec((1, 1, 1), ("pod", "data", "model"))
    batch = {"tokens": (2, 4, 8), "embeds": (2, 4, 3, 5)}
    for wa, left in ((("pod", "data"), ()), (("pod",), ("data",)),
                     ((), ("data", "model"))):
        got = tsh.batch_shardings(
            {k: torch.empty(v, device="meta") for k, v in batch.items()},
            mesh, worker_axes=wa, data_axes_left=left)
        want = jsh.batch_shardings(
            {k: jax.ShapeDtypeStruct(v, jnp.int32)
             for k, v in batch.items()}, jm, worker_axes=wa,
            data_axes_left=left)
        assert got == {k: _spec(v.spec) for k, v in want.items()}
    cache = {"k": (4, 8, 16, 2, 8), "s": (4, 8, 16), "t": (4, 8)}
    for axes in (("data",), ("pod", "data")):
        got = tsh.cache_shardings(
            {k: torch.empty(v, device="meta") for k, v in cache.items()},
            mesh, batch_axes=axes)
        want = jsh.cache_shardings(
            {k: jax.ShapeDtypeStruct(v, jnp.bfloat16)
             for k, v in cache.items()}, jm, batch_axes=axes)
        assert got == {k: _spec(v.spec) for k, v in want.items()}
    assert tsh.named(mesh, ("pod", "data"), None) \
        == _spec(jsh.named(jm, ("pod", "data"), None).spec)
    with pytest.raises(ValueError):
        tsh.named(MESHES[False], "pod")


def test_rules_tables_equal():
    assert tsh.RULES == jsh.RULES
    assert tsh.RULES_FSDP_MODEL == jsh.RULES_FSDP_MODEL
    assert tsh.RULES_EP2 == jsh.RULES_EP2
    x = torch.ones(3)
    assert tsh.maybe_constrain(x, "data") is x


@pytest.mark.parametrize("arch_id", sorted(JARCHS))
def test_leaf_specs_every_leaf(arch_id):
    """Every leaf, both meshes, every rule table, with and without FSDP
    and the worker lead, divisibility checked on the real shapes."""
    _, jshapes, jspecs = _jax_shapes(arch_id)
    model = ARCHS[arch_id].make_model()
    logical = model.param_specs()
    shapes = param_shapes(model)
    jlog = _jflat_specs(jspecs)
    jshp = _flat(jax.tree.map(lambda s: s.shape, jshapes))
    for mp, mesh in MESHES.items():
        fake = _FakeMesh(mesh)
        wa = ARCHS[arch_id].worker_axes(multi_pod=mp)
        w = ARCHS[arch_id].n_workers(multi_pod=mp)
        for rname in RULE_TABLES:
            for fsdp in (False, True):
                for lead in (False, True):
                    shp = shapes if not lead else tree_map(
                        lambda t: t.expand(w, *t.shape), shapes)
                    got = _flat(tsh.param_shardings(
                        logical, mesh, worker_axes=wa if lead else (),
                        fsdp=fsdp, with_lead=lead, shapes=shp,
                        rules=PORT_RULES[rname]))
                    for k, lg in jlog.items():
                        sh = ((w,) if lead else ()) + jshp[k]
                        want = jsh.leaf_spec(
                            lg, worker_axes=wa if lead else (), fsdp=fsdp,
                            with_lead=lead, shape=sh, mesh=fake,
                            rules=RULE_TABLES[rname])
                        assert got[k] == _spec(want), (k, rname, fsdp, lead)


# ---------------------------------------------------------------- cells

def _ref_bytes(shape, spec, mesh, itemsize) -> int:
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    n = 1
    for d, e in zip(shape, spec):
        axes = () if e is None else ((e,) if isinstance(e, str) else e)
        n *= -(-d // math.prod(mesh.shape[a] for a in axes))
    return n * itemsize


def _ref_train_arg_bytes(arch_id, mp) -> int:
    """The reference's train-cell argument bytes, summed from its specs
    and shapes: params, optimizer state, step, batch."""
    arch, shape = JARCHS[arch_id], JSHAPES["train_4k"]
    mesh = MESHES[mp]
    fake = _FakeMesh(mesh)
    jmodel, jshapes, jspecs = _jax_shapes(arch_id)
    w = arch.n_workers(multi_pod=mp)
    wa = arch.worker_axes(multi_pod=mp)
    nm = jcells._n_micro(arch, jmodel, shape, w, fake)
    total = 4                                             # step
    leaves = jax.tree.leaves(jshapes)
    specs = jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x, tuple))
    for s, lg in zip(leaves, specs, strict=True):
        full = (w,) + s.shape
        sp = jsh.leaf_spec(tuple(lg), worker_axes=wa, fsdp=arch.large,
                           shape=full, mesh=fake)
        total += _ref_bytes(full, sp, mesh, s.dtype.itemsize)
        if arch.optimizer == "adamw":
            total += 2 * _ref_bytes(full, sp, mesh, 4)
        else:                       # adafactor: vr / vc or v (float32)
            sp = tuple(sp) + (None,) * (len(full) - len(sp))
            if len(full) >= 2 and full[-1] >= 8 and full[-2] >= 8:
                total += _ref_bytes(full[:-1], sp[:-1], mesh, 4)
                total += _ref_bytes(full[:-2] + full[-1:],
                                    sp[:-2] + sp[-1:], mesh, 4)
            else:
                total += _ref_bytes(full, sp, mesh, 4)
    lead = (wa if len(wa) != 1 else wa[0]) if wa else None
    for s in jbatch_specs(arch, shape, n_workers=w).values():
        sh = s.shape if nm == 1 else \
            (s.shape[0], nm, s.shape[1] // nm) + s.shape[2:]
        extra = (None,) if nm > 1 else ()
        sp = (lead, *extra, "data" if arch.large else None)
        total += _ref_bytes(sh, sp, mesh, s.dtype.itemsize)
    return total


def _ref_serve_arg_bytes(arch_id, shape_name) -> int:
    arch, shape = JARCHS[arch_id], JSHAPES[shape_name]
    mesh = MESHES[False]
    fake = _FakeMesh(mesh)
    jmodel, jshapes, jspecs = _jax_shapes(arch_id)
    b, s = shape.global_batch, shape.seq_len
    total = 0
    for t, lg in zip(jax.tree.leaves(jshapes),
                     jax.tree.leaves(jspecs,
                                     is_leaf=lambda x: isinstance(x, tuple)),
                     strict=True):
        sp = jsh.leaf_spec(tuple(lg), worker_axes=(), fsdp=arch.large,
                           with_lead=False, shape=t.shape, mesh=fake)
        total += _ref_bytes(t.shape, sp, mesh, t.dtype.itemsize)
    cache = jax.eval_shape(lambda: jmodel.init_cache(b, s))
    dsh = "data" if b % 16 == 0 and b >= 16 else None
    for t in jax.tree.leaves(cache):
        dims = [None] * len(t.shape)
        if len(t.shape) >= 2:
            dims[1] = dsh
        for i in range(len(t.shape) - 1, 1, -1):
            if t.shape[i] % 16 == 0 and t.shape[i] >= 16:
                dims[i] = "model"
                break
        total += _ref_bytes(t.shape, dims, mesh, t.dtype.itemsize)
    for v in jbatch_specs(arch, shape).values():
        total += _ref_bytes(v.shape, (dsh,), mesh, v.dtype.itemsize)
    return total


@pytest.mark.parametrize("arch_id", sorted(JARCHS))
def test_cell_argument_bytes(arch_id):
    """Per-device argument bytes of every cell (serving cells are the
    same program on both meshes) against the reference's specs."""
    for mp in (False, True):
        cell = cells.build_cell(arch_id, "train_4k", MESHES[mp],
                                multi_pod=mp)
        assert cell.arg_bytes() == _ref_train_arg_bytes(arch_id, mp), mp
    for s in ARCHS[arch_id].shapes():
        if s.kind == "train":
            continue
        cell = cells.build_cell(arch_id, s.name, MESHES[False],
                                multi_pod=False)
        assert cell.arg_bytes() == _ref_serve_arg_bytes(arch_id, s.name), \
            s.name
        assert cell.replicas == 1
        assert cells.build_cell(arch_id, s.name, MESHES[True],
                                multi_pod=True).replicas == 2


@pytest.mark.parametrize("arch_id", sorted(JARCHS))
def test_train_cell_meta(arch_id):
    """Plan, dominant phase, microbatches and synced units of the train
    cell on both meshes: the reference's functions on a fake mesh."""
    jarch, shape = JARCHS[arch_id], JSHAPES["train_4k"]
    jmodel = jarch.make_model()
    for mp, mesh in MESHES.items():
        w = jarch.n_workers(multi_pod=mp)
        plan = jcells._plan_for(jarch, jmodel, shape, w)
        ph = jcells._dominant_phase(plan, jmodel, shape)
        nm = jcells._n_micro(jarch, jmodel, shape, w, _FakeMesh(mesh))
        meta = cells.build_cell(arch_id, "train_4k", mesh,
                                multi_pod=mp).meta
        assert meta == {
            "algo": "dreamddp", "phase": ph, "n_workers": w,
            "n_microbatches": nm, "intra_worker": "tp",
            "plan_counts": plan.meta.get("partition_counts"),
            "synced_units": list(plan.units_for_phase(ph)),
            "plan_fingerprint": plan.fingerprint()}, mp


def test_intra_worker_modes():
    """The other intra-worker modes build: dp/fsdp for a small arch,
    ep2 for a large MoE (deepseek's 256 experts over data x model)."""
    mesh = MESHES[False]
    for mode in ("dp", "fsdp"):
        cell = cells.build_cell("granite-3-2b", "train_4k", mesh,
                                multi_pod=False, intra_worker=mode)
        assert cell.meta["n_microbatches"] == 1
        assert cell.collectives.total_wire_bytes > 0
    cell = cells.build_cell("deepseek-v3-671b", "train_4k", mesh,
                            multi_pod=False, intra_worker="ep2")
    assert "all-to-all" in cell.collectives.by_kind()
    gate = cell.arg_specs[0].params["blocks"]["mlp"]["gate"]
    assert gate[2] == ("data", "model")
    with pytest.raises(ValueError):
        cells.build_cell("deepseek-v3-671b", "train_4k", mesh,
                         multi_pod=False, intra_worker="dp")


# ---------------------------------------------------------------- analysis

def test_roofline_and_collectives_parity():
    for n, t, tr in ((2.5e9, 1 << 20, True), (3e9, 4096, False)):
        assert troof.model_flops(n, t, training=tr) \
            == jroof.model_flops(n, t, training=tr)
    art = {"cost_analysis": {"flops": 3.1e15, "bytes accessed": 2.2e12},
           "collectives": {"total_wire_bytes": 5e10,
                           "total_wire_bytes_tpu": 4e10},
           "model_flops": 1.5e17, "n_devices": 256}
    for per_device in (True, False):
        a = dict(art, cost_is_per_device=per_device)
        assert troof.roofline_from_artifact(a, hw=troof.V5EConstants()) \
            .to_dict() == jroof.roofline_from_artifact(a).to_dict()
    h = troof.roofline_from_artifact(dict(art, cost_is_per_device=True))
    assert h.compute_s == 3.1e15 / 989e12 and h.collective_s == 4e10 / 50e9
    ops = [("all-reduce", 4096, 16), ("all-gather", 1 << 20, 16),
           ("reduce-scatter", 512, 2), ("all-to-all", 999, 256),
           ("collective-permute", 77, 1), ("all-reduce", 8, 1)]
    mine = coll.CollectiveSummary([coll.CollectiveOp(*o) for o in ops])
    ref = jhlo.CollectiveSummary([jhlo.CollectiveOp(*o) for o in ops])
    for a, b in zip(mine.ops, ref.ops):
        assert a.wire_bytes == b.wire_bytes
    assert mine.to_dict() == ref.to_dict()


def test_partial_sync_collectives():
    """The dominant phase's sync: one float32 all-reduce per synced leaf
    and contiguous unit range, of the per-device shard, over W."""
    cell = cells.build_cell("mamba2-780m", "train_4k", MESHES[False],
                            multi_pod=False)
    state, _ = cell.args
    pshard = cell.arg_specs[0].params
    model = ARCHS["mamba2-780m"].make_model()
    layout = model.unit_layout()
    units = cell.meta["synced_units"]
    want = coll.CollectiveSummary()
    coll.partial_sync_ops(want, state.params, pshard, MESHES[False], layout,
                          units, 16)
    got = [o for o in cell.collectives.ops if o.group_size == 16
           and o.kind == "all-reduce"]
    assert [o.result_bytes for o in got[:len(want.ops)]] \
        == [o.result_bytes for o in want.ops]
    # embed (unit 0), blocks 7..47 (units 8..48: 9 leaves, one range)
    # and the head's norm (unit 49); the table (vocab 50280, not a
    # multiple of 16) is whole on each device, in_proj's 6448 columns
    # are over model
    assert units == [0, *range(8, 50)] and len(want.ops) == 1 + 9 + 1
    sizes = [o.result_bytes for o in want.ops]
    assert sizes[0] == 50280 * 1536 * 4 and sizes[-1] == 1536 * 4
    assert 41 * 1536 * 6448 // 16 * 4 in sizes


def test_ef_state_parity():
    params = {"a": torch.ones(2, 3, dtype=torch.bfloat16),
              "b": {"c": torch.ones(2, 4)}}
    ef = ef_init(params)
    jef = jcomp.ef_init({"a": jnp.ones((2, 3), jnp.bfloat16),
                         "b": {"c": jnp.ones((2, 4))}})
    assert isinstance(ef, EFState) and EFState._fields == ("residual",)
    assert type(jef)._fields == ("residual",)
    for k, t in _flat(ef.residual).items():
        j = _flat(jef.residual)[k]
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        assert str(j.dtype) == "float32" and not t.any()


def test_cli_writes_reference_keys(tmp_path):
    """One decode cell through the CLI: the reference's artifact keys,
    the per-op table beside it, and ``reanalyze`` re-summing it."""
    rc = dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k",
                      "--mesh", "single", "--out", str(tmp_path)])
    assert rc == 0
    path = tmp_path / "granite-3-2b__decode_32k__single_pod.json"
    art = json.loads(path.read_text())
    for k in ("arch", "shape", "mesh", "kind", "n_devices", "model_flops",
              "cost_is_per_device", "memory_analysis", "cost_analysis",
              "collectives", "meta", "trace_seconds"):
        assert k in art, k
    assert set(art["memory_analysis"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes",
        "alias_size_in_bytes", "total_bytes"}
    assert set(art["cost_analysis"]) == {"flops", "bytes accessed",
                                         "n_dots", "unknown_loops"}
    assert set(art["collectives"]) == set(
        jhlo.CollectiveSummary().to_dict())
    assert art["meta"] == {"kv_depth": 32768}
    assert art["cost_analysis"]["flops"] > 0
    assert (tmp_path / "granite-3-2b__decode_32k__single_pod.ops.json.gz") \
        .exists()
    again = reanalyze(str(path))
    for k, v in art["cost_analysis"].items():
        assert again["cost_analysis"][k] == pytest.approx(v, rel=1e-12), k
    for k in ("total_wire_bytes", "n_ops"):
        assert again["collectives"][k] == pytest.approx(
            art["collectives"][k], rel=1e-12), k
    assert not torch.cuda.is_initialized()
    # the rest of the artifact's numbers are well formed
    assert np.isfinite(art["roofline_h100"]["compute_s"])
