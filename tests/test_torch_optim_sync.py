"""The port's optimizers, int8 wire format and partial syncs against the
JAX package's, on the same numpy inputs.

On the CPU:

* **fused AdamW** — the plain version (``fused_adamw_ref``, what the CPU
  runs and the oracle of the CUDA kernel) against the JAX Pallas kernel
  in interpret mode (the same float32 arithmetic: ``rtol=atol=1e-6``) and
  against JAX's ``adamw_ref`` (``2e-5``: that oracle rounds the Python
  doubles ``1 - beta`` to float32, the kernels take ``1 - beta`` in
  float32 from their ``[6]`` operand — 1.3e-5 relative in ``1 - beta2``);
* **the clip in AdamW** — ``fused_adamw_ref(..., scale=s)`` with bfloat16
  and float32 ``g`` bit for bit the composition it replaced,
  ``fused_adamw_ref(p, g.float() * s, m, v, h)``; ``adamw.update`` on the
  CPU bit for bit that composition after the ``torch.dot`` norm, written
  out here (bfloat16 and float32 grads, and no clip);
* **optimizers** — one and two ``update`` calls of every optimizer on
  identical worker-stacked grads, with the cross-worker global-norm clip
  and ``adam``'s ignored weight decay (ROADMAP.md C2): float32,
  ``rtol=2e-5, atol=1e-7`` for the fused-kernel optimizers (the ``1 -
  beta2`` rounding above), ``1e-6`` for the rest;
* **int8** — codes and scales **exactly** equal to JAX's
  ``quantize_rows_ref`` and ``quantize_int8``, including exact .5 ties
  and zero rows; dequantize exactly equal.  Against the Pallas kernel in
  interpret mode, the allowance of the reference's own sweep: XLA:CPU
  divides by 127 there as a product with the reciprocal, which puts a
  few scales one ulp off;
* **syncs** — ``compressed_worker_mean``, ``sync_units``,
  ``Int8EFSync.apply`` and ``OuterOptSync.apply`` on a worker-stacked
  tree, float32 ``1e-6``.

On the CPU too, the int8 quantize kernel's row geometry (the table the
wrapper passes to the kernel): every width from 1 to 70000 falls in
exactly one geometry that holds it, within the register and
shared-memory budgets.

On the card (``-m gpu``; skipped without CUDA): the CUDA kernels against
their plain versions on the same tensors — the int8 codes, scales and
dequantized values exactly (every geometry's boundary widths, odd
widths, misaligned rows, the .5 ties on every lane and vector slot);
fused AdamW float32 ``rtol=atol=1e-6`` and
bfloat16 within one bfloat16 rounding (the kernel and the plain version
do the same correctly rounded float32 operations; only ``powf`` in the
bias corrections may differ in the last place), also with bfloat16 ``g``
and a clip scale; the norm kernel's sum of squares against a float64
sum (relative ``1e-6``), the same bits on two calls and under a graph
replay; ``adamw.update`` with no float32 gradient tree on the card.  Run there with
``python -m pytest --noconftest -q -m gpu tests/test_torch_*.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import outer_opt  # noqa: E402
from repro_torch.core.partial_sync import (UnitEntry, UnitLayout,  # noqa: E402
                                           sync_units, tree_worker_mean)
from repro_torch.core.sync_policies import Int8EFSync, OuterOptSync  # noqa: E402
from repro_torch.kernels.fused_adam_sync import (clip_partials,  # noqa: E402
                                                 clip_scale, clip_scale_ref,
                                                 fused_adamw,
                                                 fused_adamw_ref)
from repro_torch.kernels.int8_quant import (dequantize_rows,  # noqa: E402
                                            quantize_rows)
from repro_torch.kernels.int8_quant import ops as int8_ops  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.optim.optimizers import lr_schedule  # noqa: E402
from repro_torch.parallel.compression import (  # noqa: E402
    compressed_worker_mean, dequantize_int8, quantize_int8)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(1)


def _jax():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


def _t(x, device="cpu", dtype=None):
    t = torch.from_numpy(np.array(x, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x, np.float32) if np.asarray(x).dtype.name == \
        "bfloat16" else np.asarray(x)


def _tree_close(a, b, rtol, atol):
    if a is None or b is None:
        assert a is None and b is None
        return
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _tree_close(a[k], b[k], rtol, atol)
        return
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# fused AdamW: plain version vs JAX (Pallas interpret and adamw_ref)
# ---------------------------------------------------------------------------

def _adam_case(shape, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":          # values bfloat16 holds exactly
        p = _np(torch.from_numpy(p).to(torch.bfloat16))
    g = rng.standard_normal(shape).astype(np.float32)
    m = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    v = (np.abs(rng.standard_normal(shape)) * 0.01).astype(np.float32)
    return p, g, m, v


@pytest.mark.parametrize("shape", [(64,), (300, 17), (5, 33, 9)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [0, 100])
def test_fused_adamw_ref_matches_jax(shape, dtype, step):
    jax, jnp = _jax()
    from repro.kernels.fused_adam_sync import adamw_ref, fused_adamw_step
    p, g, m, v = _adam_case(shape, len(shape) + step)
    tdt = getattr(torch, dtype)
    pt, gt, mt, vt = _t(p, dtype=tdt), _t(g), _t(m), _t(v)
    hyper = torch.tensor([1e-3, 0.9, 0.999, 1e-8, 0.1, step + 1.0])
    fused_adamw(pt, gt, mt, vt, hyper)          # CPU tensors: plain version
    jp = jnp.asarray(p, getattr(jnp, dtype))
    kern = fused_adamw_step(jp, g, m, v, 1e-3, step, weight_decay=0.1)
    ref = adamw_ref(jp, g, m, v, lr=1e-3, step=step, weight_decay=0.1)
    tol = 1e-6 if dtype == "float32" else 8e-3
    for got, want in zip((pt, mt, vt), kern, strict=True):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    for got, want in zip((pt, mt, vt), ref, strict=True):
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5,
                                   atol=max(tol, 2e-5))


def test_cpu_tensors_take_the_plain_versions_and_cuda_impl_raises():
    p, g, m, v = (_t(a) for a in _adam_case((10,), 0))
    hyper = torch.tensor([1e-3, 0.9, 0.999, 1e-8, 0.0, 1.0])
    before = (fused_adamw.launches, quantize_rows.launches,
              dequantize_rows.launches, dict(quantize_rows.launches_by_shape))
    fused_adamw(p, g, m, v, hyper)
    q, s = quantize_rows(torch.ones(2, 4))
    dequantize_rows(q, s)
    assert (fused_adamw.launches, quantize_rows.launches,
            dequantize_rows.launches,
            dict(quantize_rows.launches_by_shape)) == before
    with pytest.raises(ValueError, match="CUDA"):
        fused_adamw(p, g, m, v, hyper, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        quantize_rows(torch.ones(2, 4), impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        dequantize_rows(q, s, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        quantize_rows(torch.ones(2, 4), impl="pallas")


# ---------------------------------------------------------------------------
# the clip folded into AdamW: bit for bit the composition it replaced
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [0.0371, 1.0])
def test_fused_adamw_ref_scale_equals_scaled_f32_grads(pdtype, gdtype,
                                                       scale):
    p, g, m, v = _adam_case((5, 33, 9), 3)
    pt = _t(p, dtype=getattr(torch, pdtype))
    gt = _t(g, dtype=getattr(torch, gdtype))
    s = torch.tensor(scale, dtype=torch.float32)
    hyper = torch.tensor([1e-3, 0.9, 0.999, 1e-8, 0.1, 4.0])
    a = [pt.clone(), _t(m), _t(v)]
    b = [pt.clone(), _t(m), _t(v)]
    fused_adamw_ref(a[0], gt, a[1], a[2], hyper, s.reshape(1))
    fused_adamw_ref(b[0], gt.float() * s, b[1], b[2], hyper)
    for x, y in zip(a, b, strict=True):
        assert torch.equal(x, y)


def _plain_adamw_update(cfg, grads, m, v, params, step):
    """``adamw.update`` as the port ran it before the clip moved into the
    kernel: the ``torch.dot`` norm, a float32 copy of every gradient
    scaled by the clip, then the plain AdamW on each leaf."""
    leaves = tree_leaves(grads)
    if cfg.grad_clip:
        total = 0
        for x in leaves:
            xf = x.float().reshape(-1)
            total = total + torch.dot(xf, xf)
        s = torch.clamp(cfg.grad_clip / (torch.sqrt(total) + 1e-9), max=1.0)
        g32 = [x.float() * s for x in leaves]
    else:
        g32 = [x.float() for x in leaves]
    dev = step.device
    hyper = torch.cat([
        lr_schedule(cfg, step).reshape(1),
        torch.tensor([cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay],
                     dtype=torch.float32, device=dev),
        (step.float() + 1.0).reshape(1)])
    for p, g, mm, vv in zip(tree_leaves(params), g32, tree_leaves(m),
                            tree_leaves(v), strict=True):
        fused_adamw_ref(p, g.contiguous(), mm, vv, hyper)


@pytest.mark.parametrize("dtype,clip", [("bfloat16", 1.0), ("float32", 1.0),
                                        ("bfloat16", 0.0)])
def test_adamw_update_on_cpu_equals_plain_composition(dtype, clip):
    tdt = getattr(torch, dtype)
    opt = make_optimizer("adamw", lr=1e-2, warmup_steps=3, decay_steps=20,
                         weight_decay=0.1, grad_clip=clip)
    params = tree_map(lambda a: _t(a, dtype=tdt), _worker_tree(0))
    mine = tree_map(torch.clone, params)
    state = opt.init(mine)
    ref_m = tree_map(torch.clone, state["m"])
    ref_v = tree_map(torch.clone, state["v"])
    for k in range(2):
        grads = tree_map(lambda a: _t(a, dtype=tdt),
                         _worker_tree(1 + k, 3.0))
        step = torch.tensor(k, dtype=torch.int32)
        mine, state = opt.update(grads, state, mine, step)
        _plain_adamw_update(opt.cfg, grads, ref_m, ref_v, params, step)
    for got, want in ((mine, params), (state["m"], ref_m),
                      (state["v"], ref_v)):
        for x, y in zip(tree_leaves(got), tree_leaves(want), strict=True):
            assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------------------
# optimizers: one update on identical worker-stacked grads
# ---------------------------------------------------------------------------

W = 3


def _worker_tree(seed, grad_scale=1.0):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal(shape) * grad_scale).astype(np.float32)

    return {"embed": {"table": r(W, 16, 12)},
            "blocks": {"w": r(W, 3, 12, 10), "scale": r(W, 3, 12)},
            "head": {"norm": {"scale": r(W, 12)}}}


def _to_torch_tree(tree):
    return tree_map(lambda a: _t(a), tree)


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}),
    ("momentum", {}),
    ("adam", {}),
    ("adam", {"weight_decay": 0.5}),       # ignored, as in the reference
    ("adamw", {"weight_decay": 0.1}),
    ("adamw", {"grad_clip": 0.0}),
    ("adafactor", {}),
    ("adafactor", {"beta1": 0.0, "weight_decay": 0.05}),
])
def test_optimizer_update_matches_jax(name, kw):
    jax, jnp = _jax()
    from repro.optim import make_optimizer as jax_make_optimizer
    cfg = dict(lr=1e-2, warmup_steps=3, decay_steps=20, **kw)
    params = _worker_tree(0)
    # norms ~ 30: the global clip (max_norm 1) is active, and it is one
    # norm over all W workers together
    grads = [_worker_tree(1, 3.0), _worker_tree(2, 3.0)]

    jopt = jax_make_optimizer(name, **cfg)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    topt = make_optimizer(name, **cfg)
    tp = _to_torch_tree(params)
    ts = topt.init(tp)
    for step, g in enumerate(grads):
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                             jnp.asarray(step, jnp.int32))
        tp, ts = topt.update(_to_torch_tree(g), ts, tp,
                             torch.tensor(step, dtype=torch.int32))
    rtol, atol = (2e-5, 1e-7) if name in ("adam", "adamw") else (1e-6, 1e-7)
    _tree_close(tp, jax.device_get(jp), rtol, atol)
    _tree_close(ts, jax.device_get(js), rtol, atol)


def test_adam_ignores_weight_decay_and_clip_spans_workers():
    params, grads = _worker_tree(0), _worker_tree(1, 3.0)
    outs = []
    for wd in (0.0, 0.5):
        opt = make_optimizer("adam", lr=1e-2, weight_decay=wd)
        tp = _to_torch_tree(params)
        tp, _ = opt.update(_to_torch_tree(grads), opt.init(tp), tp,
                           torch.tensor(0, dtype=torch.int32))
        outs.append(tp)
    _tree_close(outs[0], outs[1], 0, 0)
    # clipping worker 0 alone would use its own (smaller) norm: the
    # port must use the norm over all workers, like the reference
    from repro_torch.optim.optimizers import _clip, _global_norm
    g = _to_torch_tree(grads)
    clipped = _clip(g, 1.0)
    scale = 1.0 / (float(_global_norm(g)) + 1e-9)
    np.testing.assert_allclose(_np(clipped["blocks"]["w"][0]),
                               _np(g["blocks"]["w"][0]) * scale, rtol=1e-6)


# ---------------------------------------------------------------------------
# int8: exact codes against JAX
# ---------------------------------------------------------------------------

def _tie_rows():
    """Rows whose scale is exact (max |x| = 127 a) so x / scale lands on
    .5 exactly, plus zero rows."""
    rows = []
    for a in (1.0, 0.25, 3.0, 1024.0):
        rows.append(np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5,
                              -126.5, 63.5, 0.0, -127.0], np.float32) * a)
    rows.append(np.zeros(12, np.float32))
    rows.append(np.full(12, -0.0, np.float32))
    return np.stack(rows)


@pytest.mark.parametrize("r,c", [(8, 16), (77, 33), (256, 128)])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 100.0])
def test_int8_codes_match_jax_exactly(r, c, scale):
    jax, jnp = _jax()
    from repro.kernels.int8_quant import (dequantize, dequantize_rows_ref,
                                          quantize, quantize_rows_ref)
    rng = np.random.default_rng(r * c)
    x = (rng.standard_normal((r, c)) * scale).astype(np.float32)
    x[1] = 0.0                                        # a zero row
    q, s = quantize_rows(_t(x))
    qr, sr = quantize_rows_ref(jnp.asarray(x))
    qk, sk = quantize(jnp.asarray(x))                 # Pallas interpret
    np.testing.assert_array_equal(_np(q), np.asarray(qr))
    np.testing.assert_array_equal(_np(s), np.asarray(sr))
    # XLA:CPU runs the interpreted Pallas kernel's ``/ 127`` as a product
    # with the reciprocal, so a few scales sit one ulp off the true
    # quotient (and a code may flip on a tie).  Held to the allowance of the
    # reference's own test_int8_quant_sweep: codes within one quantum on
    # < 0.1% of elements, scales rtol 1e-6.
    diff = np.abs(np.asarray(qk, np.int32) - _np(q).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    np.testing.assert_allclose(_np(s), np.asarray(sk), rtol=1e-6)
    d = dequantize_rows(q, s)
    np.testing.assert_array_equal(_np(d), np.asarray(
        dequantize_rows_ref(qr, sr)))
    assert float(np.abs(_np(q)[1]).max()) == 0
    np.testing.assert_array_equal(_np(s)[1], np.float32(1e-12))


def test_int8_ties_and_zero_rows_match_jax_exactly():
    jax, jnp = _jax()
    from repro.kernels.int8_quant import quantize, quantize_rows_ref
    x = _tie_rows()
    q, s = quantize_rows(_t(x))
    qr, sr = quantize_rows_ref(jnp.asarray(x))
    np.testing.assert_array_equal(_np(q), np.asarray(qr))
    np.testing.assert_array_equal(_np(s), np.asarray(sr))
    qk, _ = quantize(jnp.asarray(x))
    np.testing.assert_array_equal(_np(q), np.asarray(qk))
    # half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 126.5 -> 126
    np.testing.assert_array_equal(_np(q)[0, :10],
                                  [127, 0, 2, 2, 0, -2, -2, 126, -126, 64])
    assert not _np(q)[-2:].any()


# The register rows the geometry table promises at the sync's widths.
INT8_WIDTHS = {512: (32, 4), 2048: (128, 4), 8192: (256, 8)}


def _int8_sample_widths():
    """Every width to 1100, each table width and MAX_STAGED with its
    neighbours, and a stride through 70000."""
    edges = [w for w, _, _ in int8_ops.REGISTER_GEOMETRY] \
        + [int8_ops.MAX_STAGED]
    near = {e + d for e in edges for d in (-1, 0, 1)}
    return sorted(set(range(1, 1100)) | near | set(range(1100, 70001, 389))
                  | {70000})


def test_int8_quantize_geometry_covers_each_row_once():
    """Each width takes the narrowest register row whose T threads of 4V
    floats hold it, 4V <= 32 floats a thread, blocks of 256 threads
    (256 / T rows) up to T = 256; beyond, one 1024-thread block a row,
    staged in at most 224 KB of shared memory.  Which thread holds which
    element is the kernel's indexing, checked on the card."""
    table = int8_ops.REGISTER_GEOMETRY
    for cols in _int8_sample_widths():
        threads, vecs, staged = int8_ops.quantize_geometry(cols)
        if vecs == 0:                               # the loop kernel
            assert threads == int8_ops.LOOP_THREADS
            assert cols > table[-1][0]
            assert staged == (cols <= int8_ops.MAX_STAGED)
            continue
        i = [g[1:] for g in table].index((threads, vecs))
        assert not staged and (table[i - 1][0] if i else 0) < cols \
            <= table[i][0] <= 4 * vecs * threads
        assert 4 * vecs <= 32 and threads % 32 == 0 and threads <= 512
        assert (256 % threads == 0) if threads <= 256 else threads % 256 == 0
    assert int8_ops.MAX_STAGED * 4 + 4 * 32 <= 232448   # + the reduction
    for cols, want in INT8_WIDTHS.items():
        assert int8_ops.quantize_geometry(cols) == (*want, False)


def test_quantize_int8_axes_match_jax():
    jax, jnp = _jax()
    from repro.parallel.compression import dequantize_int8 as jax_deq
    from repro.parallel.compression import quantize_int8 as jax_quant
    x = np.random.default_rng(5).standard_normal((3, 5, 7)).astype(
        np.float32)
    for axis in (-1, 0, 1):
        q, s = quantize_int8(_t(x), axis=axis)
        qr, sr = jax_quant(jnp.asarray(x), axis=axis)
        np.testing.assert_array_equal(_np(q), np.asarray(qr))
        np.testing.assert_array_equal(_np(s), np.asarray(sr))
        np.testing.assert_array_equal(_np(dequantize_int8(q, s)),
                                      np.asarray(jax_deq(qr, sr)))
    gen = torch.Generator().manual_seed(0)
    qs, _ = quantize_int8(_t(x), generator=gen)      # dither: plain only
    assert qs.dtype == torch.int8 and qs.abs().max() <= 127


# ---------------------------------------------------------------------------
# syncs on a worker-stacked tree
# ---------------------------------------------------------------------------

def _layouts():
    from repro.core.partial_sync import UnitEntry as JEntry
    from repro.core.partial_sync import UnitLayout as JLayout
    spec = [("embed", "embed", None)] + [(f"layer_{i}", "blocks", i)
                                         for i in range(3)] \
        + [("head", "head", None)]
    return (UnitLayout(tuple(UnitEntry(*e) for e in spec)),
            JLayout(tuple(JEntry(*e) for e in spec)))


UNIT_SETS = [(0,), (1, 2), (1, 3), (0, 2, 4), (0, 1, 2, 3, 4), ()]


@pytest.mark.parametrize("units", UNIT_SETS)
def test_sync_units_matches_jax(units):
    jax, jnp = _jax()
    from repro.core.partial_sync import sync_units as jax_sync
    layout, jlayout = _layouts()
    params = _worker_tree(3)
    tp = _to_torch_tree(params)
    out = sync_units(tp, units, layout)
    assert out is tp                                   # in place
    want = jax_sync(jax.tree.map(jnp.asarray, params), units, jlayout)
    _tree_close(tp, jax.device_get(want), 1e-6, 1e-7)


def test_tree_worker_mean_matches_jax():
    jax, jnp = _jax()
    from repro.core.partial_sync import tree_worker_mean as jax_mean
    params = _worker_tree(4)
    _tree_close(tree_worker_mean(_to_torch_tree(params)),
                jax.device_get(jax_mean(jax.tree.map(jnp.asarray, params))),
                1e-6, 1e-7)


def test_compressed_worker_mean_matches_jax():
    jax, jnp = _jax()
    from repro.parallel.compression import \
        compressed_worker_mean as jax_cwm
    rng = np.random.default_rng(6)
    x = rng.standard_normal((W, 4, 6, 10)).astype(np.float32)
    e = (rng.standard_normal((W, 4, 6, 10)) * 1e-3).astype(np.float32)
    # a layer slice, as the sync hands it over: non-contiguous rows
    xs, es = _t(x)[:, 1:3], _t(e)[:, 1:3]
    synced, resid = compressed_worker_mean(xs, es)
    js, jr = jax_cwm(jnp.asarray(x[:, 1:3]), jnp.asarray(e[:, 1:3]))
    np.testing.assert_allclose(_np(synced), np.asarray(js), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(_np(resid), np.asarray(jr))


@pytest.mark.parametrize("units", UNIT_SETS[:4])
def test_int8_ef_sync_matches_jax(units):
    jax, jnp = _jax()
    from repro.core.sync_policies import Int8EFSync as JInt8
    layout, jlayout = _layouts()
    params = _worker_tree(7)
    pol, jpol = Int8EFSync(), JInt8()
    tp = _to_torch_tree(params)
    ef, _ = pol.init_state(tp)
    jp = jax.tree.map(jnp.asarray, params)
    jef, _ = jpol.init_state(jp)
    for _ in range(2):                    # the second sync reads the EF
        tp, ef, _ = pol.apply(tp, ef, None, units, layout)
        jp, jef, _ = jpol.apply(jp, jef, None, units, jlayout)
        tree_map(lambda x: x.add_(0.01), tp)
        jp = jax.tree.map(lambda x: x + 0.01, jp)
    _tree_close(tp, jax.device_get(jp), 1e-6, 1e-6)
    _tree_close(ef, jax.device_get(jef), 1e-6, 1e-6)


@pytest.mark.parametrize("units", UNIT_SETS[:4])
def test_outer_opt_sync_matches_jax(units):
    jax, jnp = _jax()
    from repro.core.sync_policies import OuterOptSync as JOuter
    layout, jlayout = _layouts()
    params = _worker_tree(8)
    pol, jpol = OuterOptSync(), JOuter()
    tp = _to_torch_tree(params)
    _, outer = pol.init_state(tp)
    jp = jax.tree.map(jnp.asarray, params)
    _, jouter = jpol.init_state(jp)
    for _ in range(2):
        tree_map(lambda x: x.mul_(1.1), tp)
        jp = jax.tree.map(lambda x: x * 1.1, jp)
        tp, _, outer = pol.apply(tp, None, outer, units, layout)
        jp, _, jouter = jpol.apply(jp, None, jouter, units, jlayout)
    _tree_close(tp, jax.device_get(jp), 1e-6, 1e-6)
    _tree_close(outer.outer_params, jax.device_get(jouter.outer_params),
                1e-6, 1e-6)
    _tree_close(outer.momentum, jax.device_get(jouter.momentum), 1e-6,
                1e-6)
    assert isinstance(outer, outer_opt.OuterState)


# ---------------------------------------------------------------------------
# CUDA kernels vs their plain versions (on the card only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel-vs-ref runs on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
class TestCudaKernels:
    @pytest.mark.parametrize("n", [1, 7, 1024, 1000003])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("offset", [0, 1])
    def test_fused_adamw_kernel_matches_ref(self, cuda, n, dtype, offset):
        p, g, m, v = _adam_case((n + offset,), n)
        tdt = getattr(torch, dtype)
        hyper = torch.tensor([1e-3, 0.9, 0.999, 1e-8, 0.1, 7.0],
                             device=cuda)
        # offset 1: unaligned views take the one-element loop
        a = [_t(p, cuda, tdt)[offset:]] + [_t(x, cuda)[offset:]
                                           for x in (g, m, v)]
        b = [x.clone() for x in a]
        before = fused_adamw.launches
        fused_adamw(*a, hyper)
        torch.cuda.synchronize()
        assert fused_adamw.launches == before + 1
        fused_adamw(*b, hyper, impl="ref")
        tol = 1e-6 if dtype == "float32" else 8e-3
        for x, y in zip(a, b, strict=True):
            np.testing.assert_allclose(_np(x), _np(y), rtol=tol, atol=tol)

    @pytest.mark.parametrize("n", [1, 7, 1024, 1000003])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("offset", [0, 1])
    def test_fused_adamw_kernel_scaled_matches_ref(self, cuda, n, dtype,
                                                   gdtype, offset):
        """g in its own dtype and the clip's scale read on the device,
        against the plain version at the kernel test's tolerance."""
        p, g, m, v = _adam_case((n + offset,), n)
        tdt, gdt = getattr(torch, dtype), getattr(torch, gdtype)
        hyper = torch.tensor([1e-3, 0.9, 0.999, 1e-8, 0.1, 7.0],
                             device=cuda)
        scale = torch.tensor([0.0371], device=cuda)
        a = [_t(p, cuda, tdt)[offset:], _t(g, cuda, gdt)[offset:]] + [
            _t(x, cuda)[offset:] for x in (m, v)]
        b = [x.clone() for x in a]
        before = (fused_adamw.launches, fused_adamw.scaled_launches)
        fused_adamw(*a, hyper, scale=scale)
        torch.cuda.synchronize()
        assert (fused_adamw.launches, fused_adamw.scaled_launches) == \
            (before[0] + 1, before[1] + 1)
        fused_adamw(*b, hyper, scale=scale, impl="ref")
        tol = 1e-6 if dtype == "float32" else 8e-3
        for x, y in zip(a, b, strict=True):
            np.testing.assert_allclose(_np(x), _np(y), rtol=tol, atol=tol)

    @pytest.mark.parametrize("shapes", [
        # granite's leaves, worker-stacked, at small widths
        [(4, 1000, 64), (4, 3, 64), (4, 3, 64, 64), (4, 3, 64, 16),
         (4, 3, 64, 256), (4, 3, 256, 64), (4, 64)],
        [(7,)], [(1000003,)], [(5, 33, 9), (1,), (4099,)]])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("offset", [0, 1])
    def test_clip_scale_kernel_matches_float64(self, cuda, shapes, dtype,
                                               offset):
        """The norm kernel's sum of squares against a float64 sum,
        relative 1e-6; offset 1 (2 or 4 bytes) takes the scalar loads."""
        rng = np.random.default_rng(len(shapes) + offset)
        leaves = []
        for shape in shapes:
            n = int(np.prod(shape))
            buf = _t((rng.standard_normal(n + offset) * 3).astype(
                np.float32), cuda, getattr(torch, dtype))
            leaves.append(buf[offset:].view(shape))
        scratch = torch.empty(clip_partials(leaves) + 2, device=cuda)
        before = clip_scale.launches
        scale = clip_scale(leaves, 1.0, scratch)
        torch.cuda.synchronize()
        assert clip_scale.launches == before + 1
        want = sum(float((x.double() ** 2).sum()) for x in leaves)
        got = float(scratch[-1])
        assert abs(got - want) <= 1e-6 * want, (got, want)
        norm = want ** 0.5
        assert abs(float(scale) - 1.0 / (norm + 1e-9)) \
            <= 1e-6 / (norm + 1e-9)
        ref = float(clip_scale_ref(leaves, 1.0))
        assert abs(float(scale) - ref) <= 1e-6 * ref
        # a norm under max_norm does not scale
        assert float(clip_scale(leaves, 2.0 * norm, scratch)) == 1.0

    def test_clip_scale_kernel_same_bits_twice_and_replayed(self, cuda):
        gen = torch.Generator(cuda).manual_seed(3)
        leaves = [torch.randn(shape, generator=gen, device=cuda).to(dt)
                  for shape, dt in (((4, 3, 64, 256), torch.bfloat16),
                                    ((4, 1000, 64), torch.bfloat16),
                                    ((4, 3, 64), torch.float32),
                                    ((1000003,), torch.float32))]
        scratch = torch.empty(clip_partials(leaves) + 2, device=cuda)
        first = clip_scale(leaves, 1.0, scratch).clone()
        total = scratch[-1].clone()
        second = clip_scale(leaves, 1.0, scratch).clone()
        assert torch.equal(first, second) and torch.equal(total,
                                                          scratch[-1])
        side = torch.cuda.Stream(cuda)
        side.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(side):            # warm up off the capture
            clip_scale(leaves, 1.0, scratch)
        torch.cuda.current_stream(cuda).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = clip_scale(leaves, 1.0, scratch)
        scratch.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first) and torch.equal(scratch[-1], total)

    @pytest.mark.parametrize("dtype,clip", [("bfloat16", 1.0),
                                            ("float32", 1.0),
                                            ("bfloat16", 0.0)])
    def test_adamw_update_on_cuda_makes_no_f32_grad_tree(self, cuda, dtype,
                                                         clip):
        """The norm and the scaled AdamW read the gradients as they are:
        the peak rises by less than one leaf in float32.  The result is
        the plain composition's within the kernel test's tolerance."""
        tdt = getattr(torch, dtype)
        gen = torch.Generator(cuda).manual_seed(5)
        shapes = {"embed": (4, 1000, 64), "gate": (4, 3, 64, 1024),
                  "down": (4, 3, 1024, 64), "ln": (4, 3, 64)}

        def tree(scale=1.0):
            return {k: (torch.randn(s, generator=gen, device=cuda) * scale)
                    .to(tdt) for k, s in shapes.items()}

        opt = make_optimizer("adamw", lr=1e-2, warmup_steps=3,
                             weight_decay=0.1, grad_clip=clip)
        params = tree()
        ref_p = tree_map(torch.clone, params)
        state = opt.init(params)
        ref_m = tree_map(torch.clone, state["m"])
        ref_v = tree_map(torch.clone, state["v"])
        steps = [torch.tensor(k, dtype=torch.int32, device=cuda)
                 for k in range(2)]
        grads = [tree(3.0), tree(3.0)]
        params, state = opt.update(grads[0], state, params, steps[0])
        torch.cuda.synchronize()
        largest = max(x.numel() for x in tree_leaves(params)) * 4
        torch.cuda.reset_peak_memory_stats(cuda)
        base = torch.cuda.memory_allocated(cuda)
        before = (fused_adamw.launches, fused_adamw.scaled_launches,
                  clip_scale.launches)
        params, state = opt.update(grads[1], state, params, steps[1])
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated(cuda) - base < largest
        n = len(shapes)
        assert (fused_adamw.launches - before[0],
                fused_adamw.scaled_launches - before[1],
                clip_scale.launches - before[2]) == (
            n, n if (clip or dtype != "float32") else 0, int(bool(clip)))
        for g, step in zip(grads, steps, strict=True):
            _plain_adamw_update(opt.cfg, g, ref_m, ref_v, ref_p, step)
        tol = 1e-6 if dtype == "float32" else 8e-3
        _tree_close(params, ref_p, tol, tol)
        _tree_close(state["m"], ref_m, 1e-5, 1e-6)
        _tree_close(state["v"], ref_v, 1e-5, 1e-6)

    def test_scaled_wrappers_reject_what_the_kernels_do_not_take(self,
                                                                 cuda):
        p = torch.zeros(8, device=cuda)
        h = torch.zeros(6, device=cuda)
        with pytest.raises(TypeError):
            fused_adamw(p, p.half(), p.clone(), p.clone(), h)
        with pytest.raises(ValueError, match="scale"):
            fused_adamw(p, p.clone(), p.clone(), p.clone(), h,
                        scale=torch.ones(2, device=cuda))
        with pytest.raises(ValueError, match="scratch"):
            clip_scale([p], 1.0, torch.empty(1, device=cuda))
        with pytest.raises(ValueError, match="contiguous"):
            clip_scale([torch.zeros(4, 8, device=cuda).t()], 1.0,
                       torch.empty(3, device=cuda))

    @pytest.mark.parametrize("r,c", [
        (1, 8), (5, 13), (77, 33), (64, 2048), (4097, 8192),
        # each register geometry's last width and one past it (512,
        # 2048, 8192, 16384), and widths inside them
        (9, 128), (9, 129), (9, 256), (9, 257), (77, 512), (77, 513),
        (9, 1024), (9, 1025), (3, 2048), (3, 2049), (5, 4096), (5, 4097),
        (5, 8192), (5, 8193), (3, 16384), (3, 16385),
        # odd widths, rows staged in shared memory, rows read twice
        (33, 3), (7, 4099), (3, 20000), (2, 57344), (2, 57345), (2, 70000),
        # few rows, rows not a multiple of a block's
        (4, 2048), (8, 2048), (16, 2048), (1001, 512), (999, 2048)])
    @pytest.mark.parametrize("offset", [0, 1])
    def test_int8_kernels_equal_ref(self, cuda, r, c, offset):
        rng = np.random.default_rng(r + c)
        # offset 1: contiguous rows 4 bytes past 16-byte alignment take
        # the scalar loads
        buf = _t((rng.standard_normal(r * c + offset) * 3)
                 .astype(np.float32), cuda)
        x = buf[offset:].view(r, c)
        x[0] = 0.0
        before = (quantize_rows.launches, dequantize_rows.launches,
                  quantize_rows.launches_by_shape[(r, c)])
        q, s = quantize_rows(x)
        d = dequantize_rows(q, s)
        torch.cuda.synchronize()
        assert (quantize_rows.launches, dequantize_rows.launches,
                quantize_rows.launches_by_shape[(r, c)]) == \
            (before[0] + 1, before[1] + 1, before[2] + 1)
        qr, sr = quantize_rows(x, impl="ref")
        assert torch.equal(q, qr) and torch.equal(s, sr)
        assert torch.equal(d, dequantize_rows(qr, sr, impl="ref"))

    def test_int8_kernel_ties_and_slices(self, cuda):
        x = _t(_tie_rows(), cuda)
        q, s = quantize_rows(x)
        qr, sr = quantize_rows(x, impl="ref")
        assert torch.equal(q, qr) and torch.equal(s, sr)
        e = torch.zeros(3, 4, 6, 12, device=cuda)
        p = _t(np.random.default_rng(0).standard_normal((3, 4, 6, 12))
               .astype(np.float32), cuda)
        got = compressed_worker_mean(p[:, 1:3], e[:, 1:3])
        want_q = quantize_rows((p[:, 1:3].float() + e[:, 1:3])
                               .reshape(-1, 12), impl="ref")
        deq = dequantize_rows(*want_q, impl="ref").reshape(3, 2, 6, 12)
        torch.testing.assert_close(got[1], p[:, 1:3] - deq, rtol=0, atol=0)

    @pytest.mark.parametrize("cols", [512, 2048, 8192])
    def test_int8_kernel_ties_on_every_lane(self, cuda, cols):
        """The tie rows tiled across a row, rolled by one element a row,
        so that exact .5 quotients fall on every lane, warp and float4
        slot of the geometry."""
        ties = _tie_rows()
        reps = -(-cols // ties.shape[1])
        rows = np.concatenate([np.roll(np.tile(t, reps)[:cols], k)[None]
                               for t in ties for k in range(13)])
        x = _t(rows, cuda)
        q, s = quantize_rows(x)
        qr, sr = quantize_rows(x, impl="ref")
        assert torch.equal(q, qr) and torch.equal(s, sr)
        want = np.round(rows / _np(sr)).clip(-127, 127)   # half to even
        np.testing.assert_array_equal(_np(q), want.astype(np.int8))
        assert torch.equal(dequantize_rows(q, s),
                           dequantize_rows(qr, sr, impl="ref"))

    def test_wrappers_reject_what_the_kernels_do_not_take(self, cuda):
        p = torch.zeros(8, device=cuda)
        h = torch.zeros(6, device=cuda)
        with pytest.raises(TypeError):
            fused_adamw(p.half(), p, p.clone(), p.clone(), h)
        with pytest.raises(ValueError, match="distinct"):
            fused_adamw(p, p, p.clone(), p.clone(), h)
        with pytest.raises(ValueError, match="hyper"):
            fused_adamw(p, p.clone(), p.clone(), p.clone(), h[:5])
        with pytest.raises(ValueError, match="contiguous"):
            quantize_rows(torch.zeros(4, 8, device=cuda).t())
        with pytest.raises(TypeError):
            quantize_rows(torch.zeros(4, 8, device=cuda,
                                      dtype=torch.bfloat16))
        with pytest.raises(NotImplementedError):
            quantize_int8(p, generator=torch.Generator(cuda))
