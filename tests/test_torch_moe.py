"""The port's MoE decoder against the JAX package's, on the CPU.

Inputs are made with numpy from a seed; parameters are the JAX package's
own, carried across with ``params_from_numpy``.  Everything is float32.

* **The layer** — ``moe_apply`` for both routers, with and without
  shared experts, at a capacity that really drops tokens (asserted),
  and its gradients: ``atol=rtol=1e-5`` (float32 sums in another order).
  The one-hot of a dropped token's out-of-range slot is a zero row, as
  ``jax.nn.one_hot`` gives; capacities equal the reference's.  Exact
  ties in the router scores (both routers, at the smoke geometry and at
  deepseek-v3's 256 experts top-8) take the experts ``jax.lax.top_k``
  takes, the lower index first: indices equal, outputs within ``1e-5``.
* **The model** — a variant of qwen3-moe-30b-a3b ``SMOKE`` with one
  leading dense block (the ``dense_blocks`` group), a sigmoid router
  and a shared expert: logits, loss, gradients, prefill caches,
  contiguous and paged decode within ``1e-4`` (3 layers of float32
  sums; they agree so only while no expert choice flips);
  for it and for ``SMOKE`` itself, the block groups, ``unit_layout`` and
  ``layer_costs`` exactly.  ``SMOKE``'s own logits, loss, gradients,
  caches and decode are held in ``tests/test_torch_model.py``, with the
  other archs'.  Decode through the cache against the full forward at
  dropless capacity, as the reference's own test does (capacity drops
  depend on the sequence length, so a one-token step may keep what a
  full pass drops).
* **Serving** — greedy streams, finish reasons, the completion order,
  peak pages and every ``EngineStats`` counter equal to the JAX
  ``ServeEngine``'s, on contiguous and paged KV and with right-padded
  chunked prefill (whose capacity counts the pad, as the reference's).
* **Training** — a 2-worker ``Session.fit`` of the MoE smoke, H = 2, 4
  steps, against the JAX per-step session from its initial parameters
  and batches: plan fingerprints equal, per-step losses within
  ``rtol=1e-5``.

On the card (``-m gpu``; skipped without CUDA, and run there without
JAX): the paged and flash kernels at the MoE geometry (32/4 heads, head
width 128) against their plain versions, and the MoE smoke's decode
block as a CUDA graph replay (the routing's stable sort captured),
bitwise the eager block.  Run there with ``python -m pytest
--noconftest -q -m gpu tests/test_torch_*.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
try:
    import jax
    jnp = jax.numpy
    from repro.configs import get_arch as jget_arch
    from repro.models import moe as jmoe
    from repro.models.layers import Init
    from repro.models.transformer import DecoderLM as JDecoderLM
except ImportError:     # the card's machine has no JAX: the gpu tests run
    jax = None

from repro_torch.api import JobConfig, Session  # noqa: E402
from repro_torch.configs import get_arch, qwen3_moe_30b_a3b  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serve import EngineConfig, Request, ServeEngine  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

torch.set_num_threads(1)

ARCH = "qwen3-moe-30b-a3b"
TOL = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


@pytest.fixture(autouse=True)
def _reference(request):
    """Every test but the card's compares with the JAX package."""
    if jax is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("needs the JAX package (the reference)")


@pytest.fixture(scope="module")
def reference():
    """The same skip for module-scoped fixtures, which come first."""
    if jax is None:
        pytest.skip("needs the JAX package (the reference)")


# ---------------------------------------------------------------- the layer

def test_capacity_matches_reference():
    full = qwen3_moe_30b_a3b.CONFIG.moe
    jfull = jget_arch(ARCH).make_model().cfg.moe
    assert [full.capacity(s) for s in (1, 256, 512)] == [8, 20, 40]
    for cfg, jcfg in ((full, jfull),
                      (qwen3_moe_30b_a3b.SMOKE.moe,
                       jget_arch(ARCH).make_smoke().cfg.moe)):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        for s in (1, 2, 3, 7, 12, 16, 100, 256, 512, 1000):
            assert cfg.capacity(s) == jcfg.capacity(s)


def test_one_hot_gives_a_zero_row_out_of_range():
    idx = np.array([[0, 2, 3], [1, 4, 2]], np.int32)      # 3 and 4: no row
    got = tmoe._one_hot(torch.from_numpy(idx), 3, torch.float32)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.nn.one_hot(jnp.asarray(idx), 3)))


_LAYER = dict(n_experts=4, top_k=2, d_ff=24, capacity_factor=0.5)


@pytest.mark.parametrize("router,n_shared", [
    ("softmax", 0), ("softmax", 1), ("sigmoid", 0), ("sigmoid", 2)])
def test_moe_apply_and_grads_match_reference_with_drops(router, n_shared):
    kw = dict(_LAYER, router=router, n_shared=n_shared,
              routed_scale=2.5 if router == "sigmoid" else 1.0)
    jcfg, tcfg = jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)
    d, b, s = 16, 2, 10
    jp = jax.device_get(jmoe.moe_init(Init(jax.random.PRNGKey(3)), jcfg, d,
                                      dtype=jnp.float32)[0])
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, s, d), np.float32)
    r = rng.standard_normal((b, s, d), np.float32)

    # the capacity drops: top-k assignments past each expert's c slots
    c = jcfg.capacity(s)
    _, idx = jmoe._route(jcfg, jnp.asarray(x) @ jp["router"]["w"])
    counts = np.stack([np.bincount(np.asarray(idx)[i].ravel(),
                                   minlength=jcfg.n_experts)
                       for i in range(b)])
    assert np.maximum(counts - c, 0).sum() > 0

    def jloss(p, x):
        return jnp.sum(jmoe.moe_apply(p, jcfg, x) * r)

    want = jax.jit(lambda p, x: jmoe.moe_apply(p, jcfg, x))(
        jp, jnp.asarray(x))
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = tree_map(lambda t: t.requires_grad_(), params_from_numpy(jp, "cpu"))
    tx = torch.from_numpy(x).requires_grad_()
    got = tmoe.moe_apply(tp, tcfg, tx)
    _close(got, want, 1e-5)
    (got * torch.from_numpy(r)).sum().backward()
    _close(tx.grad, jgx, 1e-5)
    gp, wp = _flat(tree_map(lambda t: t.grad, tp)), \
        _flat(jax.device_get(jgp))
    assert gp.keys() == wp.keys()
    for k in gp:
        _close(gp[k], wp[k], 1e-5)


# router columns drawn from 3 distinct columns of small dyadic values and
# small-integer inputs: every logit is exact in float32 whatever the
# summation order, so equal columns give exactly equal scores (ties at
# the top-k boundary, asserted) on both sides; token 0 is all zeros, a
# tie across every expert
_TIE_GEOMETRY = {"smoke": dict(n_experts=8, top_k=2, d_ff=24),
                 "dsv3": dict(n_experts=256, top_k=8, d_ff=8)}


@pytest.mark.parametrize("geometry", sorted(_TIE_GEOMETRY))
@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_routing_ties_follow_jax_top_k(router, geometry):
    """``jax.lax.top_k`` puts the lower index first on ties; the port's
    routing takes the same experts in the same order (indices equal),
    so ``moe_apply`` agrees within ``1e-5`` (float32 sums)."""
    kw = dict(_TIE_GEOMETRY[geometry], n_shared=1, router=router,
              routed_scale=2.5 if router == "sigmoid" else 1.0)
    jcfg, tcfg = jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)
    d, b, s = 16, 2, 6
    jp = jax.device_get(jmoe.moe_init(Init(jax.random.PRNGKey(5)), jcfg, d,
                                      dtype=jnp.float32)[0])
    rng = np.random.default_rng(6)
    cols = rng.integers(-4, 5, (d, 3)).astype(np.float32) / 8
    jp["router"]["w"] = cols[:, rng.integers(0, 3, jcfg.n_experts)]
    x = rng.integers(-2, 3, (b, s, d)).astype(np.float32)
    x[0, 0] = 0.0
    logits = x @ jp["router"]["w"]

    jw, jidx = jmoe._route(jcfg, jnp.asarray(logits))
    tw, tidx = tmoe._route(tcfg, torch.from_numpy(logits))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tw, jw, 1e-6)
    k = jcfg.top_k
    np.testing.assert_array_equal(tidx[0, 0].numpy(), np.arange(k))
    scores = np.sort(np.asarray(torch.sigmoid(torch.from_numpy(logits))
                                if router == "sigmoid" else
                                torch.softmax(torch.from_numpy(logits), -1)),
                     -1)[..., ::-1]
    assert (scores[..., k - 1] == scores[..., k]).mean() > 0.5

    want = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    _close(tmoe.moe_apply(params_from_numpy(jp, "cpu"), tcfg,
                          torch.from_numpy(x)), want, 1e-5)


def test_moe_init_layout_scales_and_counts():
    cfg = tmoe.MoEConfig(n_experts=6, top_k=2, d_ff=40, n_shared=1)
    p = tmoe.moe_init(torch.Generator().manual_seed(0), cfg, 32,
                      dtype=torch.bfloat16, stack=(3,))
    jp = jax.eval_shape(lambda k: jmoe.moe_init(
        Init(k), jmoe.MoEConfig(**dataclasses.asdict(cfg)), 32)[0],
        jax.random.PRNGKey(0))
    ours, theirs = _flat(p), _flat(jp)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert tuple(ours[k].shape) == (3, *theirs[k].shape), k
        assert ours[k].dtype == (torch.float32 if "router" in k
                                 else torch.bfloat16), k
    assert abs(p["gate"].float().std().item() - 32 ** -0.5) < 0.01
    assert abs(p["down"].float().std().item() - 40 ** -0.5) < 0.01
    assert sum(v.numel() for v in ours.values()) == \
        3 * tmoe.moe_param_count(cfg, 32) == \
        3 * jmoe.moe_param_count(jmoe.MoEConfig(**dataclasses.asdict(cfg)),
                                 32)


# ---------------------------------------------------------------- the model

def _dense1(cfg, moe_cls):
    """One leading dense block, a sigmoid router with a shared expert."""
    return dataclasses.replace(
        cfg, name="moe-dense1", n_dense_layers=1, dense_d_ff=40,
        moe=moe_cls(**{**dataclasses.asdict(cfg.moe), "router": "sigmoid",
                       "n_shared": 1, "routed_scale": 2.5}))


def _make(name):
    jm, tm = jget_arch(ARCH).make_smoke(), get_arch(ARCH).make_smoke()
    if name == "dense1":
        jm = JDecoderLM(_dense1(jm.cfg, jmoe.MoEConfig))
        tm = DecoderLM(_dense1(tm.cfg, tmoe.MoEConfig))
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    return jm, jp, tm, params_from_numpy(jp, "cpu")


@pytest.fixture(scope="module")
def made(reference):
    """Each model pair, made once for the module on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _make(name)
        return cache[name]
    return get


@pytest.fixture(scope="module", params=["smoke", "dense1"])
def pair(request, made):
    return made(request.param)


@pytest.fixture(scope="module")
def dense1(made):
    return made("dense1")


def test_groups_follow_runs(pair):
    jm, jp, tm, tp = pair
    assert tm.cfg.runs() == jm.cfg.runs()
    groups = [g for g, _, _ in tm.cfg.runs()]
    own = tm.init(torch.Generator().manual_seed(0))
    assert list(own) == ["embed", *groups, "head"]
    assert set(own) == set(tp) == set(jp)
    assert {k: tuple(v.shape) for k, v in _flat(own).items()} == \
        {k: v.shape for k, v in _flat(jp).items()}
    assert [(e.name, e.group, e.index) for e in tm.unit_layout().entries] \
        == [(e.name, e.group, e.index) for e in jm.unit_layout().entries]
    for mode in ("train", "decode"):
        assert tm.layer_costs(2, 16, mode=mode) == \
            jm.layer_costs(2, 16, mode=mode)
    assert tm.param_count() == jm.param_count() == \
        sum(v.size for v in _flat(jp).values())
    assert tm.active_param_count() == jm.active_param_count()


def test_logits_loss_and_grads_match(dense1):
    jm, jp, tm, tp = dense1
    toks = _tokens(0, (2, 12), tm.cfg.vocab)
    _close(tm.apply(tp, torch.from_numpy(toks)),
           jm.apply(jp, jnp.asarray(toks)))
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(jp, jbatch)
    tp = tree_map(lambda x: x.detach().clone().requires_grad_(), tp)
    t = torch.from_numpy(toks).long()
    loss = tm.loss(tp, {"tokens": t, "labels": t})
    loss.backward()
    _close(loss, jloss)
    got, want = _flat(tree_map(lambda x: x.grad, tp)), \
        _flat(jax.device_get(jgrads))
    assert got.keys() == want.keys()
    for k in got:
        _close(got[k], want[k])


def test_prefill_and_decode_match(dense1):
    jm, jp, tm, tp = dense1
    b, s, max_seq = 2, 9, 16
    toks = _tokens(1, (b, s), tm.cfg.vocab)
    jlog, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(b, max_seq))
    tlog, tc = tm.prefill(tp, torch.from_numpy(toks),
                          tm.init_cache(b, max_seq, device="cpu"))
    _close(tlog, jlog)
    tok = _tokens(2, (b, 1), tm.cfg.vocab)
    pos = np.full((b,), s, np.int32)
    jlog, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
    tlog, tc = tm.decode_step(tp, tc, torch.from_numpy(tok),
                              torch.from_numpy(pos))
    _close(tlog, jlog)
    assert tc.keys() == jc.keys()
    for group in tc:
        for name in ("k", "v"):
            _close(tc[group][name], jc[group][name])


def test_paged_decode_matches(dense1):
    jm, jp, tm, tp = dense1
    cfg = tm.cfg
    rng = np.random.default_rng(4)
    slots, ps, mb = 3, 4, 3
    n_pages = 1 + slots * mb
    pages = {group: {n: rng.standard_normal(
        (layers, n_pages, ps, cfg.n_kv_heads, cfg.hd), np.float32)
        for n in ("k", "v")} for group, _kind, layers in cfg.runs()}
    bt = rng.permutation(np.arange(1, n_pages)).reshape(slots, mb) \
        .astype(np.int32)
    pos = np.array([5, 11, 0], np.int32)
    active = np.array([True, True, False])
    tok = _tokens(5, (slots, 1), cfg.vocab)
    jlog, jpages = jm.decode_step_paged(
        jp, jax.tree.map(jnp.asarray, pages), jnp.asarray(tok),
        jnp.asarray(pos), jnp.asarray(bt), jnp.asarray(active))
    tlog, tpages = tm.decode_step_paged(
        tp, params_from_numpy(pages, "cpu"), torch.from_numpy(tok),
        torch.from_numpy(pos), torch.from_numpy(bt),
        torch.from_numpy(active))
    _close(tlog, jlog)
    for group in pages:
        for name in ("k", "v"):
            _close(tpages[group][name][:, 1:],
                   np.asarray(jpages[group][name])[:, 1:])


@pytest.mark.parametrize("name", ["smoke", "dense1"])
def test_decode_matches_full_forward_dropless(name):
    """As the reference's ``test_smoke_decode_matches_full_forward``:
    capacity factor = n_experts, so nothing is dropped."""
    tm = get_arch(ARCH).make_smoke()
    if name == "dense1":
        tm = DecoderLM(_dense1(tm.cfg, tmoe.MoEConfig))
    moe = dataclasses.replace(tm.cfg.moe,
                              capacity_factor=float(tm.cfg.moe.n_experts))
    tm = DecoderLM(dataclasses.replace(tm.cfg, moe=moe))
    p = tm.init(torch.Generator().manual_seed(0))
    b, s = 2, 12
    toks = torch.from_numpy(_tokens(1, (b, s), tm.cfg.vocab)).long()
    with torch.no_grad():
        lg, cache = tm.prefill(p, toks, tm.init_cache(b, s + 4,
                                                      device="cpu"))
        _close(lg[:, 0], tm.apply(p, toks)[:, -1], 2e-3)
        nxt = lg.argmax(-1)
        lg2, _ = tm.decode_step(p, cache, nxt,
                                torch.full((b,), s, dtype=torch.int32))
        full2 = tm.apply(p, torch.cat([toks, nxt], 1))
    _close(lg2[:, 0], full2[:, -1], 5e-3)


# ---------------------------------------------------------------- serving

_PROMPT_LENS = (6, 6, 9, 12, 6, 3)
_BUDGETS = (5, 3, 7, 2, 6, 4)
_EOS_REQ = 2
_COUNTERS = ("requests_completed", "prompt_tokens", "generated_tokens",
             "decode_ticks", "prefill_batches", "admit_ticks",
             "slot_ticks_active", "slot_ticks_total")


def _drive(engine, request_cls, vocab, eos_id):
    rng = np.random.default_rng(0)
    for i, (n, g) in enumerate(zip(_PROMPT_LENS, _BUDGETS, strict=True)):
        engine.submit(request_cls(
            tokens=rng.integers(0, vocab, n).tolist(), max_new_tokens=g,
            request_id=i, eos_id=eos_id if i == _EOS_REQ else None))
    order, comps = [], {}
    while engine.has_work:
        done = engine.step()
        order.append(sorted(c.request_id for c in done))
        comps.update((c.request_id, c) for c in done)
    st = engine.stats
    out = {"tokens": {i: c.tokens for i, c in comps.items()},
           "finish": {i: c.finish_reason for i, c in comps.items()},
           "order": order,
           "stats": {k: getattr(st, k) for k in _COUNTERS}}
    if engine.pool.backend == "paged":
        out["peak_pages"] = engine.pool.peak_pages_in_use
    return out


@pytest.fixture(scope="module")
def smoke(made):
    return made("smoke")


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(kv_backend="paged", page_size=8),
    dict(kv_backend="paged", page_size=8, prefill_chunk=8),
], ids=["contiguous", "paged", "paged-chunked"])
def test_engine_matches_jax_engine(smoke, cfg):
    from repro.serve import EngineConfig as JConfig
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JEngine
    jm, jp, tm, tp = smoke
    cfg = dict(max_batch=4, max_seq=32, decode_block=4, **cfg)
    vocab = tm.cfg.vocab
    first = _drive(ServeEngine(tm, tp, EngineConfig(**cfg), device="cpu"),
                   Request, vocab, None)
    eos_id = first["tokens"][_EOS_REQ][2]        # stops at its 3rd token
    ours = _drive(ServeEngine(tm, tp, EngineConfig(**cfg), device="cpu"),
                  Request, vocab, eos_id)
    theirs = _drive(JEngine(jm, jax.tree.map(jnp.asarray, jp),
                            JConfig(**cfg)), JRequest, vocab, eos_id)
    assert ours == theirs
    assert ours["finish"][_EOS_REQ] == "stop"


# ---------------------------------------------------------------- training

def test_session_fit_matches_jax_per_step():
    from repro.api import JobConfig as JJobConfig
    from repro.api import Session as JSession
    from repro.data import MarkovCorpus as JMarkovCorpus
    job = dict(arch=ARCH, smoke=True, algo="dreamddp", workers=2, period=2,
               seq=16, batch_per_worker=2, lr=3e-3, warmup_steps=2,
               decay_steps=50)
    js = JSession(JJobConfig(**job, fused_period=False))
    init = jax.device_get(jax.tree.map(lambda a: a[0], js.state.params))
    js.fit(4)

    class Batches:                       # the JAX corpus's batches
        corpus = JMarkovCorpus(vocab=256, seq_len=16, batch_per_worker=2,
                               n_workers=2, seed=0)

        def batch(self, step):
            b = jax.device_get(self.corpus.batch(step))
            return {k: torch.from_numpy(np.array(v)).long()
                    for k, v in b.items()}

        def entropy_floor(self):
            return self.corpus.entropy_floor()

    ts = Session(JobConfig(**job), data=Batches(),
                 params=params_from_numpy(init, "cpu"), device="cpu")
    assert ts.plan.fingerprint() == js.plan.fingerprint()
    ts.fit(4)
    np.testing.assert_allclose([h["loss"] for h in ts.history],
                               [h["loss"] for h in js.history], rtol=1e-5)


# ---------------------------------------------------------------- the card

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run on the card)")
    return torch.device("cuda")


# the MoE serve geometry: 32 query heads over 4 KV heads, head width 128
_NQ, _NKV, _HD = 32, 4, 128
_KERNEL_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        device=device, dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_paged_kernel_at_the_moe_geometry(cuda, dtype):
    """8 slots, page 16, 34 blocks, ragged kv_len up to 544."""
    rng = np.random.default_rng(11)
    slots, ps, mb = 8, 16, 34
    n_pages = 1 + slots * mb
    kv_len = rng.integers(1, mb * ps + 1, slots)
    kv_len[0], kv_len[-1] = ps, mb * ps
    bt = rng.permutation(np.arange(1, n_pages)).reshape(slots, mb)
    for i in range(slots):
        bt[i, -(-int(kv_len[i]) // ps):] = 0
    args = (_randn(rng, (slots, _NQ, _HD), dtype, cuda),
            _randn(rng, (n_pages, ps, _NKV, _HD), dtype, cuda),
            _randn(rng, (n_pages, ps, _NKV, _HD), dtype, cuda),
            torch.tensor(bt, dtype=torch.int32, device=cuda),
            torch.tensor(kv_len, dtype=torch.int32, device=cuda))
    before = paged_attention.launches
    got = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    tol = _KERNEL_TOL[dtype]
    _close(got, paged_attention(*args, impl="ref"), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s", [(2, 256), (1, 512)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_kernel_at_the_moe_geometry(cuda, b, s, dtype):
    rng = np.random.default_rng(s)
    q = _randn(rng, (b, s, _NQ, _HD), dtype, cuda)
    k = _randn(rng, (b, s, _NKV, _HD), dtype, cuda)
    v = _randn(rng, (b, s, _NKV, _HD), dtype, cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert torch.isfinite(got.float()).all()
    _close(got, flash_attention(q, k, v, causal=True, impl="ref"),
           _KERNEL_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["paged", "contiguous"])
def test_moe_decode_block_graph_is_bitwise_the_eager_block(cuda, backend):
    model = get_arch(ARCH).make_smoke()
    params = model.init(torch.Generator("cuda").manual_seed(0))
    kw = dict(max_batch=4, max_seq=32, decode_block=4)
    if backend == "paged":
        kw.update(kv_backend="paged", page_size=8)
    graph = ServeEngine(model, params, EngineConfig(**kw), keep_logits=True)
    eager = ServeEngine(model, params, EngineConfig(**kw),
                        cuda_graphs=False, keep_logits=True)
    rng = np.random.default_rng(0)
    for n, g in zip(_PROMPT_LENS, _BUDGETS, strict=True):
        req = Request(tokens=rng.integers(0, model.cfg.vocab, n).tolist(),
                      max_new_tokens=g)
        graph.submit(req)
        eager.submit(dataclasses.replace(req))
    done = {"graph": [], "eager": []}
    while graph.has_work or eager.has_work:
        done["graph"] += graph.step()
        done["eager"] += eager.step()
        torch.cuda.synchronize()
        assert torch.equal(graph.last_logits, eager.last_logits)
    assert {c.request_id: c.tokens for c in done["graph"]} == \
        {c.request_id: c.tokens for c in done["eager"]}
    assert graph.block_stats.graphs == 2
    if backend == "paged":
        per_replay = model.cfg.n_layers * 4
        assert graph.block_stats.kernel_launches() == {
            "paged_attention": per_replay * graph.block_stats.replays}
