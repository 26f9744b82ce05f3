"""The reference's last public names in the port, against the JAX
package's on the same numpy inputs.

On the CPU:

* ``data.TeacherImages`` — the teacher's two matrices **equal** to the
  reference's (the same numpy draws), and the reference's own images
  pushed through the port's labelling give **equal** labels; the port's
  images come from its own generators (one stream per worker and step);
* ``kernels.fused_adam_sync.{fused_adamw_step, fused_adamw_tree}``
  against the reference's (its Pallas kernel in interpret mode), float32
  ``rtol=atol=1e-6``, bfloat16 8e-3, and ``adamw_ref`` against the
  reference's ``adamw_ref`` at ``2e-5`` — the tolerances of
  ``tests/test_torch_optim_sync.py`` (ROADMAP C5: the kernels take ``1 -
  beta2`` in float32, 1.3e-5 relative in ``v``);
* ``kernels.int8_quant.{quantize, dequantize}`` — codes and scales
  **equal** to the reference's ``quantize_rows_ref``, values **equal** to
  its ``dequantize_rows_ref`` in float32 and bfloat16; against the
  reference's Pallas ``quantize`` in interpret mode, the allowance of
  its own sweep (XLA:CPU divides by 127 as a product with the
  reciprocal).

* the last 14 names (ROADMAP A13′): ``api``'s ``resolve_policy`` and six
  serving re-exports, ``runtime``'s ``make_prefill_step`` /
  ``make_decode_step``, the pools' ``n_free`` / ``n_free_pages`` /
  ``block_table_row`` / ``device_block_tables`` (**equal** to the JAX
  pool's under the churn of ``tests/test_paged_pool.py``) and
  ``kernels.paged_attention.paged_attention_fwd`` (against the
  reference's in interpret mode at both ``skip_pages``, float32
  ``rtol=atol=2e-5``, the bound the reference's own test holds its kernel
  to against its oracle).

On the card (``-m gpu``; skipped without CUDA): each alias's kernel path
against its plain path on the same tensors, with its launches counted.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import TeacherImages  # noqa: E402
from repro_torch.kernels.fused_adam_sync import (adamw_ref,  # noqa: E402
                                                 fused_adamw,
                                                 fused_adamw_step,
                                                 fused_adamw_tree)
from repro_torch.kernels.int8_quant import (dequantize,  # noqa: E402
                                            dequantize_rows, quantize,
                                            quantize_rows)

TEACHER = dict(n_classes=10, image_dim=64, batch_per_worker=5, n_workers=3,
               seed=2)


def _jax():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _adam_case(shape, seed, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    m = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    v = (np.abs(rng.standard_normal(shape)) * 0.01).astype(np.float32)
    pt = torch.from_numpy(p).to(device=device, dtype=dtype)
    return [pt] + [torch.from_numpy(a).to(device) for a in (g, m, v)]


# ------------------------------------------------------------ TeacherImages

def test_teacher_images_equal_the_reference():
    jax, jnp = _jax()
    from repro.data import TeacherImages as JaxTeacher
    d, jd = TeacherImages(**TEACHER), JaxTeacher(**TEACHER)
    np.testing.assert_array_equal(_np(d._w1), np.asarray(jd._w1))
    np.testing.assert_array_equal(_np(d._w2), np.asarray(jd._w2))
    for step in (0, 7):
        jb = jd.batch(step)
        got = d.labels(torch.from_numpy(np.array(jb["images"])))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), np.asarray(jb["labels"]))


def test_teacher_images_streams():
    d = TeacherImages(**TEACHER)
    b0, b1 = d.batch(0), d.batch(1)
    assert b0["images"].shape == (3, 5, 64) and b0["labels"].shape == (3, 5)
    assert b0["images"].dtype == torch.float32
    assert b0["labels"].dtype == torch.int32
    assert torch.equal(d.batch(0)["images"], b0["images"])   # pure in step
    assert not torch.equal(b1["images"], b0["images"])
    x = b0["images"]
    assert not torch.equal(x[0], x[1]) and not torch.equal(x[1], x[2])
    assert torch.equal(b0["labels"], d.labels(x))
    assert int(b0["labels"].min()) >= 0 and int(b0["labels"].max()) < 10
    # worker k's stream does not depend on how many workers there are
    two = TeacherImages(**{**TEACHER, "n_workers": 2}).batch(0)
    assert torch.equal(two["images"], x[:2])


# ---------------------------------------------------------------- AdamW

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [0, 100])
def test_fused_adamw_step_and_adamw_ref_match_jax(dtype, step):
    jax, jnp = _jax()
    from repro.kernels.fused_adam_sync import adamw_ref as jadamw_ref
    from repro.kernels.fused_adam_sync import \
        fused_adamw_step as jfused_adamw_step
    p, g, m, v = _adam_case((300, 17), step, getattr(torch, dtype))
    # copies: JAX may alias a numpy buffer and reads it asynchronously,
    # while the port's step below updates p, m and v in place
    jp = jnp.asarray(_np(p).copy(), getattr(jnp, dtype))
    jg, jm, jv = (jnp.asarray(_np(t).copy()) for t in (g, m, v))
    want_k = jfused_adamw_step(jp, jg, jm, jv, 1e-3, step, weight_decay=0.1)
    want_r = jadamw_ref(jp, jg, jm, jv, lr=1e-3, step=step,
                        weight_decay=0.1)

    before = [t.clone() for t in (p, g, m, v)]
    ref = adamw_ref(p, g, m, v, lr=1e-3, step=step, weight_decay=0.1)
    assert all(torch.equal(a, b) for a, b in zip(before, (p, g, m, v),
                                                 strict=True))
    assert ref[0].dtype == p.dtype and ref[1].dtype == torch.float32
    launches = fused_adamw.launches
    got = fused_adamw_step(p, g, m, v, 1e-3, step, weight_decay=0.1)
    assert fused_adamw.launches == launches           # the CPU: plain path
    assert all(a is b for a, b in zip(got, (p, m, v), strict=True))

    tol = 1e-6 if dtype == "float32" else 8e-3
    for a, b in zip(got, want_k, strict=True):
        np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)
    for a, b in zip(ref, want_r, strict=True):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-5,
                                   atol=max(tol, 2e-5))
    for a, b in zip(got, ref, strict=True):           # one arithmetic
        assert torch.equal(a, b)


def test_fused_adamw_tree_matches_jax():
    jax, jnp = _jax()
    from repro.kernels.fused_adam_sync import \
        fused_adamw_tree as jfused_adamw_tree
    leaves = {"b": _adam_case((7,), 1), "a": {"w": _adam_case((5, 9), 2)}}
    trees = [{"b": leaves["b"][i], "a": {"w": leaves["a"]["w"][i]}}
             for i in range(4)]
    jtrees = [jax.tree_util.tree_map(lambda t: jnp.asarray(_np(t).copy()),
                                     t) for t in trees]
    want = jfused_adamw_tree(*jtrees, 1e-3, 3, weight_decay=0.1)
    got = fused_adamw_tree(*trees, 1e-3, 3, weight_decay=0.1)
    assert got[0] is trees[0] and got[1] is trees[2] and got[2] is trees[3]
    for g_tree, w_tree in zip(got, want, strict=True):
        for key in ("b", "a"):
            a = g_tree["b"] if key == "b" else g_tree["a"]["w"]
            b = w_tree["b"] if key == "b" else w_tree["a"]["w"]
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6,
                                       atol=1e-6)


# ----------------------------------------------------------------- int8

@pytest.mark.parametrize("r,c", [(8, 16), (77, 33)])
@pytest.mark.parametrize("scale", [1e-3, 100.0])
def test_int8_aliases_equal_jax(r, c, scale):
    jax, jnp = _jax()
    from repro.kernels.int8_quant import (dequantize_rows_ref,
                                          quantize_rows_ref)
    from repro.kernels.int8_quant import quantize as jquantize
    rng = np.random.default_rng(r * c)
    x = (rng.standard_normal((r, c)) * scale).astype(np.float32)
    x[1] = 0.0                                        # a zero row
    launches = (quantize_rows.launches, dequantize_rows.launches)
    q, s = quantize(torch.from_numpy(x))
    qr, sr = quantize_rows_ref(jnp.asarray(x))
    np.testing.assert_array_equal(_np(q), np.asarray(qr))
    np.testing.assert_array_equal(_np(s), np.asarray(sr))
    qk, sk = jquantize(jnp.asarray(x))                # Pallas interpret
    diff = np.abs(np.asarray(qk, np.int32) - _np(q).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    np.testing.assert_allclose(_np(s), np.asarray(sk), rtol=1e-6)
    for dtype in ("float32", "bfloat16"):
        d = dequantize(q, s, getattr(torch, dtype))
        assert d.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_np(d), _np(dequantize_rows_ref(
            qr, sr, dtype=getattr(jnp, dtype))))
    assert (quantize_rows.launches, dequantize_rows.launches) == launches


# ----------------------------------------------------- the last 14 names

def _api_name(name):
    import repro_torch.api as api
    from repro_torch import serve
    from repro_torch.core import sync_policies
    got = getattr(api, name)
    assert name in api.__all__
    home = sync_policies if name == "resolve_policy" else serve
    assert got is getattr(home, name)


def _runtime_name(name):
    import repro_torch.runtime as runtime
    from repro_torch.configs import get_arch
    assert name in runtime.__all__
    model = get_arch("granite-3-2b").make_smoke()
    params = model.init(torch.Generator().manual_seed(0))
    tok = torch.tensor([[3, 5, 7, 11]])
    cache = model.init_cache(1, 8, device="cpu")
    if name == "make_prefill_step":
        got, _ = runtime.make_prefill_step(model)(params, tok, cache)
        want, _ = model.prefill(params, tok, model.init_cache(
            1, 8, device="cpu"))
    else:
        model.prefill(params, tok, cache)
        step = torch.tensor([[2]])
        pos = torch.tensor([4], dtype=torch.int32)
        other = model.init_cache(1, 8, device="cpu")
        model.prefill(params, tok, other)
        got, _ = runtime.make_decode_step(model)(params, cache, step, pos)
        want, _ = model.decode_step(params, other, step, pos)
    assert torch.equal(got, want)


def _pool_name(name):
    from repro_torch.serve import CachePool
    pool = _port_pool()
    attr = getattr(type(pool), name)
    assert isinstance(attr, property) == name.startswith("n_")
    if name == "n_free":
        assert isinstance(CachePool.n_free, property)
        assert pool.n_free == pool.n_slots
    elif name == "n_free_pages":
        assert pool.n_free_pages == pool.n_usable_pages
    elif name == "block_table_row":
        slot = pool.alloc(20)
        pool.extend(slot, 20)
        row = pool.block_table_row(slot)
        assert row.dtype == torch.int32 and row.device == pool.device
        assert row.tolist() == pool.block_tables[slot].tolist()
    else:
        tables = pool.device_block_tables()
        assert tables.dtype == torch.int32
        assert tuple(tables.shape) == (pool.n_slots, pool.max_blocks)


def _kernel_name(name):
    from repro_torch.kernels import paged_attention as pa
    assert name in pa.__all__ and callable(getattr(pa, name))


NAMES = {
    **{n: _api_name for n in ("resolve_policy", "ServeEngine",
                              "EngineConfig", "Request", "SamplingParams",
                              "Completion", "EngineStats")},
    "make_prefill_step": _runtime_name, "make_decode_step": _runtime_name,
    "n_free": _pool_name, "n_free_pages": _pool_name,
    "block_table_row": _pool_name, "device_block_tables": _pool_name,
    "paged_attention_fwd": _kernel_name,
}


@pytest.mark.parametrize("name", list(NAMES))
def test_last_public_names(name):
    NAMES[name](name)


def _port_pool(n_slots=4, max_seq=64, page_size=8, n_pages=None):
    from repro_torch.configs import get_arch
    from repro_torch.serve import PagedCachePool
    model = get_arch("qwen3-1.7b").make_smoke()
    return PagedCachePool(model, n_slots, max_seq, page_size=page_size,
                          n_pages=n_pages, device="cpu")


def _jax_pool(n_slots=4, max_seq=64, page_size=8, n_pages=None):
    _jax()
    from repro.configs import get_arch
    from repro.serve import PagedCachePool
    model = get_arch("qwen3-1.7b").make_smoke()
    return PagedCachePool(model, n_slots, max_seq, page_size=page_size,
                          n_pages=n_pages)


def _same_pools(port, ref):
    assert port.n_free == ref.n_free
    assert port.n_free_pages == ref.n_free_pages
    tables = port.device_block_tables()
    np.testing.assert_array_equal(tables.numpy(),
                                  np.asarray(ref.device_block_tables()))
    for slot in range(port.n_slots):
        np.testing.assert_array_equal(port.block_table_row(slot).numpy(),
                                      np.asarray(ref.block_table_row(slot)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_pool_accessors_equal_jax_under_churn(seed):
    """``tests/test_paged_pool.py::test_alloc_extend_free_churn``'s seeded
    admit / grow / release sequence on both pools: every accessor equal
    after every operation."""
    import random
    rng = random.Random(seed)
    port = _port_pool(n_slots=6, max_seq=64, page_size=8, n_pages=25)
    ref = _jax_pool(n_slots=6, max_seq=64, page_size=8, n_pages=25)
    live: dict[int, int] = {}
    grown: dict[int, int] = {}
    for _ in range(300):
        op = rng.random()
        if op < 0.45:
            need = rng.randint(1, 64)
            slot = port.alloc(need)
            assert slot == ref.alloc(need)
            if slot is not None:
                live[slot] = need
                grown[slot] = rng.randint(1, need)
                port.extend(slot, grown[slot])
                ref.extend(slot, grown[slot])
        elif op < 0.75 and live:
            slot = rng.choice(list(live))
            grown[slot] = min(live[slot], grown[slot] + rng.randint(0, 16))
            port.extend(slot, grown[slot])
            ref.extend(slot, grown[slot])
        elif live:
            slot = rng.choice(list(live))
            port.free(slot)
            ref.free(slot)
            del live[slot], grown[slot]
        _same_pools(port, ref)
    for slot in list(live):
        port.free(slot)
        ref.free(slot)
    _same_pools(port, ref)
    assert port.n_free_pages == port.n_usable_pages
    assert port.n_free == port.n_slots


def test_pool_accessors_equal_jax_clamp_and_free():
    """``tests/test_paged_pool.py::
    test_extend_clamps_to_commitment_and_free_returns_pages`` on both
    pools."""
    port = _port_pool(n_slots=2, max_seq=64, page_size=8, n_pages=17)
    ref = _jax_pool(n_slots=2, max_seq=64, page_size=8, n_pages=17)
    for pool in (port, ref):
        slot = pool.alloc(17)                 # commits 3 pages
        pool.extend(slot, 64)                 # asks for 8, clamped to 3
    _same_pools(port, ref)
    assert (port.block_table_row(slot) > 0).sum().item() == 3
    before = port.n_free_pages
    port.free(slot)
    ref.free(slot)
    assert port.n_free_pages == before + 3
    _same_pools(port, ref)
    with pytest.raises(ValueError):
        port.free(slot)


def _paged_inputs(seed, slots, nq, nkv, hd, ps, mb):
    """Ragged kv_len (one slot at one token), permuted pages, tables
    padded with the trash page past each slot's pages."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + slots * mb
    q = rng.standard_normal((slots, nq, hd)).astype(np.float32)
    kp = rng.standard_normal((n_pages, ps, nkv, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, nkv, hd)).astype(np.float32)
    kv_len = rng.integers(1, mb * ps + 1, size=slots).astype(np.int32)
    kv_len[0], kv_len[-1] = 1, mb * ps
    bt = rng.permutation(np.arange(1, n_pages)).reshape(slots, mb)
    for s in range(slots):
        bt[s, -(-int(kv_len[s]) // ps):] = 0
    return q, kp, vp, bt.astype(np.int32), kv_len


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("skip_pages", [True, False])
@pytest.mark.parametrize("interpret", [True, False])
def test_paged_attention_fwd_matches_jax(window, skip_pages, interpret):
    """The alias against the reference's Pallas kernel in interpret mode,
    float32 ``rtol=atol=2e-5``; both ``skip_pages`` values give the same
    bits, and the CPU path (``interpret=False`` on CPU tensors) is the
    plain version, no launch counted."""
    jax, jnp = _jax()
    from repro.kernels.paged_attention.kernel import \
        paged_attention_fwd as jfwd
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_fwd)
    args = _paged_inputs(31, 3, 4, 2, 16, 8, 4)
    want = jfwd(*map(jnp.asarray, args), window=window,
                skip_pages=skip_pages, interpret=True)
    tq, tk, tv, tbt, tlen = map(torch.from_numpy, args)
    launches = paged_attention.launches
    got = paged_attention_fwd(tq, tk, tv, tbt.long(), tlen, window=window,
                              skip_pages=skip_pages, interpret=interpret)
    assert paged_attention.launches == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    other = paged_attention_fwd(tq, tk, tv, tbt, tlen, window=window,
                                skip_pages=not skip_pages,
                                interpret=interpret)
    assert torch.equal(got, other)


# ---------------------------------------------------- on the card (gpu)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel-vs-plain runs on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
class TestCudaAliases:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_fused_adamw_step_and_tree_kernel_vs_plain(self, cuda, dtype):
        tdt = getattr(torch, dtype)
        a = _adam_case((1000, 33), 5, tdt, cuda)
        want = adamw_ref(*a, lr=1e-3, step=9, weight_decay=0.1)
        before = fused_adamw.launches
        got = fused_adamw_step(*a, torch.tensor(1e-3, device=cuda), 9,
                               weight_decay=0.1)
        torch.cuda.synchronize()
        assert fused_adamw.launches == before + 1
        tol = 1e-6 if dtype == "float32" else 8e-3
        for x, y in zip(got, want, strict=True):
            np.testing.assert_allclose(_np(x), _np(y), rtol=tol, atol=tol)
        trees = [{"a": x, "b": y} for x, y in zip(
            _adam_case((64,), 1, tdt, cuda), _adam_case((3, 5), 2, tdt, cuda),
            strict=True)]
        plain = [{k: t.clone() for k, t in tree.items()} for tree in trees]
        fused_adamw_tree(*trees, 1e-3, 4)
        assert fused_adamw.launches == before + 3
        for k in ("a", "b"):
            want = adamw_ref(*(t[k] for t in plain), lr=1e-3, step=4)
            for x, y in zip((trees[0][k], trees[2][k], trees[3][k]), want,
                            strict=True):
                np.testing.assert_allclose(_np(x), _np(y), rtol=tol,
                                           atol=tol)

    @pytest.mark.parametrize("r,c", [(77, 33), (64, 2048)])
    def test_int8_aliases_kernel_vs_plain(self, cuda, r, c):
        rng = np.random.default_rng(r + c)
        x = torch.from_numpy((rng.standard_normal((r, c)) * 3)
                             .astype(np.float32)).to(cuda)
        before = (quantize_rows.launches, dequantize_rows.launches)
        q, s = quantize(x)
        d = dequantize(q, s, torch.bfloat16)
        torch.cuda.synchronize()
        assert (quantize_rows.launches, dequantize_rows.launches) == \
            (before[0] + 1, before[1] + 1)
        qr, sr = quantize_rows(x, impl="ref")
        assert torch.equal(q, qr) and torch.equal(s, sr)
        assert torch.equal(d, dequantize_rows(qr, sr, impl="ref")
                           .to(torch.bfloat16))

    @pytest.mark.parametrize("skip_pages", [True, False])
    def test_paged_attention_fwd_kernel_vs_plain(self, cuda, skip_pages):
        from repro_torch.kernels.paged_attention import (
            paged_attention, paged_attention_fwd)
        args = [torch.from_numpy(a).to(cuda) for a in
                _paged_inputs(31, 3, 4, 2, 16, 8, 4)]
        before = paged_attention.launches
        got = paged_attention_fwd(*args, skip_pages=skip_pages)
        torch.cuda.synchronize()
        assert paged_attention.launches == before + 1
        want = paged_attention_fwd(*args, interpret=True)
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5,
                                   atol=2e-5)

    def test_teacher_images_on_the_card(self, cuda):
        d = TeacherImages(**TEACHER, device=cuda)
        b = d.batch(3)
        assert b["images"].is_cuda and b["labels"].is_cuda
        assert torch.equal(d.batch(3)["images"], b["images"])
        cpu = TeacherImages(**TEACHER)
        assert torch.equal(d._w1.cpu(), cpu._w1)
        assert torch.equal(b["labels"], d.labels(b["images"]))
