"""The port's Griffin hybrid (RG-LRU + local MQA) against the JAX
package's ``RGLM``, on the CPU, at recurrentgemma-9b's ``SMOKE`` (5
layers: one (rec, rec, attn) superblock and a 2-layer rec tail; d_model
32, 4 heads over 1 KV head of width 8, window 8, lru 32, vocab 256,
float32).

Parameters are the port's (a JAX init of the smoke model costs ~13 s of
CPU), carried to JAX as numpy; inputs are made with numpy from a seed.

* **Structure** — configs, the init's keys, shapes and dtypes (``lam``
  float32 in a bfloat16 model), ``unit_layout``, ``layer_costs``,
  ``param_count`` (8,578,519,040 at full width) and the plan fingerprint
  **exactly**.
* **The recurrence** — :func:`rg_lru_scan` (a doubling scan) against the
  reference's ``associative_scan``, with and without ``h0``, within
  ``1e-5`` relative (the two combine in another order; that is the only
  rounding difference).
* **The model** — logits, the loss and its gradients (with and without
  remat), prefill logits and every cache leaf (the ring's ``pos``
  included) for prompts shorter and longer than the window, and 12
  decode steps with the two lanes at their own positions across a ring
  wrap, each lane held to a one-lane reference call at its position:
  ``TOL`` (float32 sums in another order over a few layers).  The ring
  read as pages through the plain paged kernel, and through the
  kernel's split-K arithmetic, equals the reference's ring attention
  within ``1e-5``.
* **Serving** — greedy streams, finish reasons, completion order and
  every ``EngineStats`` counter **equal** to the JAX ``ServeEngine``'s on
  the contiguous backend; the paged backend refused by both.
* **Training** — ``Session.fit`` against the JAX session, in
  ``tests/test_torch_rglru_fit.py`` (a file of its own: each JAX fit
  compiles for ~15 s).

On the card (``-m gpu``; skipped without CUDA, and run there without
JAX): the decode block as a CUDA graph replay, bitwise the eager block,
through the paged kernel over the rings; run there with ``python -m
pytest --noconftest -q -m gpu tests/test_torch_*.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
try:
    import jax
    jnp = jax.numpy
    from repro.configs import get_arch as jget_arch
    from repro.configs import recurrentgemma_9b as jax_rg
    from repro.models import layers as jlayers
    from repro.models import rglru as jrglru
except ImportError:     # the card's machine has no JAX: the gpu tests run
    jax = None

from repro_torch.api import JobConfig, Session  # noqa: E402
from repro_torch.configs import get_arch, recurrentgemma_9b  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention, paged_attention_split_ref)
from repro_torch.models.rglru import RGLM, rg_lru_scan  # noqa: E402
from repro_torch.serve import EngineConfig, Request, ServeEngine  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

torch.set_num_threads(1)

ARCH = "recurrentgemma-9b"
SMOKE = recurrentgemma_9b.SMOKE
FULL_PARAMS = 8_578_519_040
TOL = 1e-5          # the model: float32 sums over a few layers
SCAN_RTOL = 1e-5    # the doubling scan against associative_scan


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _flat(tree, prefix=""):
    if isinstance(tree, (dict, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, SMOKE.vocab, shape,
                                                dtype=np.int32)


@pytest.fixture(autouse=True)
def _reference(request):
    """Every test but the card's compares with the JAX package."""
    if jax is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("needs the JAX package (the reference)")


@pytest.fixture(scope="module")
def model():
    """(JAX model, its params, the port's model, its params): the port's
    seeded init, carried to JAX as numpy."""
    if jax is None:
        pytest.skip("needs the JAX package (the reference)")
    tm = RGLM(SMOKE)
    tp = tm.init(torch.Generator().manual_seed(0))
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))
    return jrglru.RGLM(jax_rg.SMOKE), jp, tm, tp


# ---------------------------------------------------------------- structure

@pytest.mark.parametrize("name", ["CONFIG", "SMOKE"])
def test_config_and_arch_match_reference(name):
    ours, theirs = (getattr(m, name) for m in (recurrentgemma_9b, jax_rg))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    arch = get_arch(ARCH)
    make = "make_model" if name == "CONFIG" else "make_smoke"
    assert isinstance(getattr(arch, make)(), RGLM)
    assert getattr(arch, make)().cfg == ours
    assert arch.family == jget_arch(ARCH).family == "hybrid"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_layout_and_dtypes_match_reference(dtype):
    """Same keys, shapes and dtypes as the reference's init (``lam``
    float32 in a bfloat16 model), and ``params_from_numpy`` keeps each
    leaf's dtype."""
    cfg = dataclasses.replace(SMOKE, param_dtype=dtype)
    ours = _flat(RGLM(cfg).init(torch.Generator().manual_seed(0)))
    jcfg = dataclasses.replace(jax_rg.SMOKE, param_dtype=dtype)
    theirs = _flat(jax.eval_shape(jrglru.RGLM(jcfg).init,
                                  jax.random.PRNGKey(0)))
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert tuple(ours[k].shape) == theirs[k].shape, k
        assert str(ours[k].dtype).removeprefix("torch.") \
            == theirs[k].dtype.name, k
    assert ours["/blocks/sub0/lam"].dtype == torch.float32
    # the reference's own leaves (ml_dtypes bfloat16 and float32 lam) keep
    # their dtypes through params_from_numpy
    jtree = jax.device_get(jax.tree.map(
        lambda a: jnp.zeros(a.shape, a.dtype),
        jax.eval_shape(jrglru.RGLM(jcfg).init, jax.random.PRNGKey(0))))
    back = _flat(params_from_numpy(jtree, "cpu"))
    assert {k: v.dtype for k, v in back.items()} \
        == {k: v.dtype for k, v in ours.items()}


@pytest.mark.parametrize("which", ["SMOKE", "CONFIG"])
def test_layout_costs_counts_and_fingerprint_match(which):
    from repro.api import JobConfig as JJobConfig
    from repro.api import Session as JSession
    smoke = which == "SMOKE"
    make = "make_smoke" if smoke else "make_model"
    tm, jm = getattr(get_arch(ARCH), make)(), getattr(jget_arch(ARCH),
                                                      make)()
    entries = [dataclasses.astuple(e) for e in tm.unit_layout().entries]
    assert entries == [dataclasses.astuple(e)
                       for e in jm.unit_layout().entries]
    assert [e[0] for e in entries[-3:]] == (
        ["tail_0", "tail_1", "head"])
    for mode in ("train", "decode"):
        assert tm.layer_costs(8, 4096, mode=mode) == \
            jm.layer_costs(8, 4096, mode=mode)
    assert tm.param_count() == jm.param_count() \
        == tm.active_param_count() == jm.active_param_count()
    if smoke:
        assert tm.param_count() == sum(
            v.numel() for v in _flat(tm.init(torch.Generator())).values())
    else:
        assert tm.param_count() == FULL_PARAMS
    job = dict(arch=ARCH, smoke=smoke, workers=4, period=3)
    assert Session(JobConfig(**job), device="cpu").plan.fingerprint() == \
        JSession(JJobConfig(**job)).plan.fingerprint()


# ---------------------------------------------------------------- the scan

@pytest.mark.parametrize("length,seed_h0", [(1, True), (13, False),
                                            (13, True), (64, True)])
def test_rg_lru_scan_matches_associative_scan(length, seed_h0):
    rng = np.random.default_rng(length)
    log_a = -np.abs(rng.standard_normal((2, length, 6), np.float32))
    bt = rng.standard_normal((2, length, 6), np.float32)
    h0 = rng.standard_normal((2, 6), np.float32) if seed_h0 else None
    hs, h_fin = rg_lru_scan(torch.from_numpy(log_a), torch.from_numpy(bt),
                            None if h0 is None else torch.from_numpy(h0))
    jhs, jfin = jrglru.rg_lru_scan(jnp.asarray(log_a), jnp.asarray(bt),
                                   None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(_np(hs), np.asarray(jhs), rtol=SCAN_RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(_np(h_fin), np.asarray(jfin), rtol=SCAN_RTOL,
                               atol=1e-6)


# ---------------------------------------------------------------- the model

def test_apply_logits_match(model):
    jm, jp, tm, tp = model
    tok = _tokens(1, (2, 21))
    with torch.no_grad():
        ours = tm.apply(tp, torch.from_numpy(tok))
    _close(ours, jax.jit(jm.apply)(jp, jnp.asarray(tok)))


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax_grad(model, remat):
    jm, jp, _, tp = model
    tm = RGLM(dataclasses.replace(SMOKE, remat=remat))
    tok = _tokens(2, (2, 19))
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    loss = tm.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    _close(loss, jloss)
    ours, theirs = _flat(tp), _flat(jax.device_get(jgrads))
    for k in ours:
        _close(ours[k].grad, theirs[k])


def _cmap(fn, *trees):
    """``fn`` over the leaves of same-shaped caches (dicts and tuples)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _cmap(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple):
        return tuple(_cmap(fn, *xs) for xs in zip(*trees, strict=True))
    return fn(*trees)


def test_prefill_and_ring_decode_match_per_lane(model):
    """Two lanes prefilled apart (5 tokens, under the window of 8, and
    13, over it), each prefill's logits and every cache leaf held to the
    reference's; then 12 decode steps of both lanes together, each at
    its own position (the first lane's ring wraps at step 3), every lane
    held to a one-lane reference call at its position, logits and cache
    leaves."""
    jm, jp, tm, tp = model
    lens = (5, 13)
    prompts = [_tokens(3 + i, (1, n)) for i, n in enumerate(lens)]
    jprefill = jax.jit(jm.prefill)
    jdecode = jax.jit(jm.decode_step)
    lanes, jcaches = [], []
    for tok in prompts:
        with torch.no_grad():
            lg, cache = tm.prefill(tp, torch.from_numpy(tok),
                                   tm.init_cache(1, 64, device="cpu"))
        jlg, jcache = jprefill(jp, jnp.asarray(tok), jm.init_cache(1, 64))
        _close(lg, jlg)
        ours, theirs = _flat(cache), _flat(jax.device_get(jcache))
        assert ours.keys() == theirs.keys()
        for k in ours:
            assert tuple(ours[k].shape) == theirs[k].shape, k
            assert str(ours[k].dtype).removeprefix("torch.") \
                == theirs[k].dtype.name, k
            _close(ours[k], theirs[k])
        lanes.append(cache)
        jcaches.append(jcache)
    # the two one-lane caches side by side: a two-lane cache
    cache = _cmap(lambda a, b: torch.cat([a, b], 1), *lanes)
    rng = np.random.default_rng(7)
    pos = np.array(lens, np.int32)
    for _ in range(12):
        step = rng.integers(0, SMOKE.vocab, (2, 1), dtype=np.int32)
        with torch.no_grad():
            lg, out = tm.decode_step(tp, cache, torch.from_numpy(step),
                                     torch.from_numpy(pos))
        assert out is cache                          # updated in place
        for b in range(2):
            jlg, jcaches[b] = jdecode(jp, jcaches[b],
                                      jnp.asarray(step[b:b + 1]),
                                      jnp.asarray(pos[b:b + 1]))
            _close(lg[b:b + 1], jlg)
            ours = _flat(_cmap(lambda t: t[:, b:b + 1], cache))
            theirs = _flat(jax.device_get(jcaches[b]))
            for k in ours:
                _close(ours[k], theirs[k])
        pos += 1


@pytest.mark.parametrize("window", [8, 48])
@pytest.mark.parametrize("at", [[0, 5, 7, 8], [8, 30, 47, 48],
                                [95, 100, 141, 200]])
def test_ring_as_pages_equals_the_reference_ring_attention(window, at):
    """A ring written position by position up to each lane's query at
    ``at``, read as pages through :meth:`RGLM.ring_table` with ``kv_len
    = pos + 1`` folded into ``(window, 2 window]``: the plain paged
    kernel, and the kernel's split-K arithmetic at 1 and 2 pages a
    split, equal the reference's ring attention (``gqa_attention`` over
    the ring's stored positions) within ``1e-5``."""
    cfg = dataclasses.replace(SMOKE, window=window)
    tm = RGLM(cfg)
    b, nq, hd = len(at), cfg.n_heads, cfg.hd
    rng = np.random.default_rng(window + at[0])
    ring = {n: np.zeros((b, window, 1, hd), np.float32) for n in "kv"}
    ring_pos = np.full((b, window), -10 ** 9, np.int32)
    for lane, p in enumerate(at):
        for t in range(p + 1):                       # every write so far
            slot = t % window
            for n in "kv":
                ring[n][lane, slot] = rng.standard_normal((1, hd))
            ring_pos[lane, slot] = t
    q = rng.standard_normal((b, 1, nq, hd)).astype(np.float32)
    qpos = np.array(at, np.int32)[:, None]
    want = jlayers.gqa_attention(
        jnp.asarray(q), jnp.asarray(ring["k"]), jnp.asarray(ring["v"]),
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(ring_pos),
        causal=True, window=window)[:, 0]
    ps = tm.ring_page
    pages = [torch.from_numpy(ring[n]).view(-1, ps, 1, hd) for n in "kv"]
    table = tm.ring_table(b, "cpu")
    assert table.shape == (b, 2 * window // ps)
    kv_len = torch.tensor(at, dtype=torch.int32) + 1
    kv_len = torch.where(kv_len > window, (kv_len - 1) % window + 1 + window,
                         kv_len)
    qt = torch.from_numpy(q[:, 0])
    got = paged_attention(qt, *pages, table, kv_len, window=window)
    _close(got, want)
    for pps in (1, 2):
        _close(paged_attention_split_ref(qt, *pages, table, kv_len,
                                         pages_per_split=pps, window=window),
               want)


# ---------------------------------------------------------------- serving

_PROMPT_LENS = (5, 11, 9, 3, 14, 6)
_BUDGETS = (9, 4, 7, 12, 3, 6)
_EOS_REQ = 2
_COUNTERS = ("requests_completed", "prompt_tokens", "generated_tokens",
             "decode_ticks", "prefill_batches", "admit_ticks",
             "slot_ticks_active", "slot_ticks_total")
_ENGINE = dict(max_batch=3, max_seq=32, decode_block=4)


def _drive(engine, request_cls, eos_id):
    rng = np.random.default_rng(0)
    for i, (n, g) in enumerate(zip(_PROMPT_LENS, _BUDGETS, strict=True)):
        engine.submit(request_cls(
            tokens=rng.integers(0, SMOKE.vocab, n).tolist(),
            max_new_tokens=g, request_id=i,
            eos_id=eos_id if i == _EOS_REQ else None))
    order, comps = [], {}
    while engine.has_work:
        done = engine.step()
        order.append(sorted(c.request_id for c in done))
        comps.update((c.request_id, c) for c in done)
    st = engine.stats
    return {"tokens": {i: c.tokens for i, c in comps.items()},
            "finish": {i: c.finish_reason for i, c in comps.items()},
            "order": order,
            "stats": {k: getattr(st, k) for k in _COUNTERS}}


def test_engine_matches_jax_engine(model):
    """Six requests over three slots (prompts over the window, and
    budgets that wrap the rings), one stopping at an EOS."""
    from repro.serve import EngineConfig as JConfig
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JEngine
    jm, jp, tm, tp = model
    first = _drive(ServeEngine(tm, tp, EngineConfig(**_ENGINE),
                               device="cpu"), Request, None)
    eos_id = first["tokens"][_EOS_REQ][2]        # stops at its 3rd token
    ours = _drive(ServeEngine(tm, tp, EngineConfig(**_ENGINE),
                              device="cpu"), Request, eos_id)
    theirs = _drive(JEngine(jm, jp, JConfig(**_ENGINE)), JRequest, eos_id)
    assert ours == theirs
    assert ours["finish"][_EOS_REQ] == "stop"


def test_paged_backend_refused_as_the_reference_refuses_it(model):
    from repro.serve import EngineConfig as JConfig
    from repro.serve import ServeEngine as JEngine
    jm, jp, tm, tp = model
    cfg = dict(max_batch=2, max_seq=32, kv_backend="paged", page_size=8)
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(tm, tp, EngineConfig(**cfg), device="cpu")
    with pytest.raises(ValueError, match="paged"):
        JEngine(jm, jp, JConfig(**cfg))
    with pytest.raises(ValueError, match="recurrent state"):
        ServeEngine(tm, tp, EngineConfig(max_batch=1, max_seq=32,
                                         prefill_chunk=8), device="cpu")


def test_prefill_runs_flash_and_decode_the_paged_wrapper(model,
                                                          monkeypatch):
    """Every attention layer of a prefill calls the flash wrapper and of a
    decode step the paged wrapper (their plain versions here: the CPU
    tensors), with the window."""
    _, _, tm, tp = model
    import repro_torch.models.rglru as rg
    calls = []
    for name in ("flash_attention", "paged_attention"):
        real = getattr(rg, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, kw["window"]))
            return _real(*a, **kw)

        monkeypatch.setattr(rg, name, spy)
    launches = (flash_attention.launches, paged_attention.launches)
    cache = tm.init_cache(2, 32, device="cpu")
    with torch.no_grad():
        tm.prefill(tp, torch.from_numpy(_tokens(5, (2, 11))), cache)
        tm.decode_step(tp, cache, torch.from_numpy(_tokens(6, (2, 1))),
                       torch.tensor([11, 11], dtype=torch.int32))
    w, n = SMOKE.window, SMOKE.n_super
    assert calls == [("flash_attention", w)] * n \
        + [("paged_attention", w)] * n
    assert (flash_attention.launches, paged_attention.launches) == launches


# ---------------------------------------------------------------- the card

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the decode block is a CUDA graph)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_rg_decode_block_graph_is_bitwise_the_eager_block(cuda):
    model = get_arch(ARCH).make_smoke()
    params = model.init(torch.Generator("cuda").manual_seed(0))
    graph = ServeEngine(model, params, EngineConfig(**_ENGINE),
                        keep_logits=True)
    eager = ServeEngine(model, params, EngineConfig(**_ENGINE),
                        cuda_graphs=False, keep_logits=True)
    # the engine holds the scratch the model asks for (none when one
    # split covers the smoke's two-page table)
    assert (graph._attn_scratch is None) == \
        (model.decode_scratch(3, cuda) is None)
    rng = np.random.default_rng(0)
    for n, g in zip(_PROMPT_LENS, _BUDGETS, strict=True):
        req = Request(tokens=rng.integers(0, SMOKE.vocab, n).tolist(),
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
    per_replay = SMOKE.n_super * _ENGINE["decode_block"]
    assert graph.block_stats.captured_launches == {
        v: {"paged_attention": per_replay} for v in ("greedy", "sampled")}
