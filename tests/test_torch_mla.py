"""The port's MLA and multi-token prediction against the JAX package's,
on the CPU, at deepseek-v3-671b's ``SMOKE`` (MLA 4 heads, q-rank 24,
kv-rank 16, nope 16, rope 8, v 16; d_model 48; 1 dense + 2 MoE blocks of
8 experts top-2 with a shared expert; one MTP block; float32).

Inputs are made with numpy from a seed.  The layer's parameters are the
JAX package's own (``mla_init``); the model's are the port's, carried to
JAX as numpy (a JAX init of the smoke model costs ~13 s of CPU).

* **The layer** — ``mla_apply_full`` (one query block, and blocks of 4
  recomputed in the backward pass), its latents and gradients;
  contiguous decode with one position for every lane and with a
  position per lane (the reference writes all lanes at ``pos[0]``, so
  each lane is held to a one-lane reference call); paged decode with an
  inactive lane: ``atol=rtol=1e-5`` (float32 sums in another order).
  The absorbed decode of a token equals the expanded forward at its
  position, on both cache layouts, within ``1e-5``.
* **The model** — the MTP loss term alone and its gradients within
  ``1e-4`` (a block and the head of float32 sums); ``unit_layout``,
  ``layer_costs``, ``param_count`` and the plan fingerprint **exactly**,
  for ``SMOKE`` and ``CONFIG``; ``sync_units`` on the unstacked ``mtp``
  group as the reference's.  ``SMOKE``'s logits, loss with MTP,
  gradients, caches and decodes are held in ``tests/test_torch_model.py``
  with the other archs'.
* **Serving** — greedy streams, finish reasons, completion order, peak
  pages and every ``EngineStats`` counter **equal** to the JAX
  ``ServeEngine``'s on contiguous and paged KV.
* **Training** — a 2-worker ``Session.fit``, H = 2, 4 steps, against the
  JAX per-step session from the same parameters and batches: plan
  fingerprints equal, per-step losses within ``rtol=1e-5``.

On the card (``-m gpu``; skipped without CUDA, and run there without
JAX): the MLA smoke's decode block as a CUDA graph replay, bitwise the
eager block, on paged and contiguous KV; the MLA engine holds no paged
kernel scratch and launches neither attention kernel.  Run there with
``python -m pytest --noconftest -q -m gpu tests/test_torch_*.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
try:
    import jax
    jnp = jax.numpy
    from repro.configs import get_arch as jget_arch
    from repro.models import mla as jmla
    from repro.models.layers import Init
    from repro.models.transformer import DecoderLM as JDecoderLM
except ImportError:     # the card's machine has no JAX: the gpu tests run
    jax = None

from repro_torch.api import JobConfig, Session  # noqa: E402
from repro_torch.configs import deepseek_v3_671b, get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core.partial_sync import sync_units, worker_stack  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serve import EngineConfig, Request, ServeEngine  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

torch.set_num_threads(1)

ARCH = "deepseek-v3-671b"
CFG = deepseek_v3_671b.SMOKE.mla
D = deepseek_v3_671b.SMOKE.d_model
TOL = 1e-4          # the model: float32 sums over a block and the head
LAYER_TOL = 1e-5    # one layer: float32 sums in another order


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


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


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


@pytest.fixture(scope="module")
def layer(reference):
    """The reference's MLA parameters at the smoke widths, both sides."""
    jp = jax.device_get(jmla.mla_init(Init(jax.random.PRNGKey(1)), CFG, D,
                                      dtype=jnp.float32)[0])
    return jp, params_from_numpy(jp, "cpu")


# ---------------------------------------------------------------- the layer

def test_config_init_and_counts_match_reference():
    full = deepseek_v3_671b.CONFIG.mla
    for ours, theirs in ((CFG, jget_arch(ARCH).make_smoke().cfg.mla),
                         (full, jget_arch(ARCH).make_model().cfg.mla)):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.qk_dim == theirs.qk_dim
    assert full.qk_dim == 192
    p = tmla.mla_init(torch.Generator().manual_seed(0), CFG, D,
                      dtype=torch.bfloat16, stack=(3,))
    jp = jax.eval_shape(lambda k: jmla.mla_init(Init(k), CFG, D)[0],
                        jax.random.PRNGKey(0))
    ours, theirs = _flat(p), _flat(jp)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert tuple(ours[k].shape) == (3, *theirs[k].shape), k
        assert ours[k].dtype == torch.bfloat16, k
    assert abs(p["w_uk"].float().std().item() - 16 ** -0.5) < 0.02
    for cfg, d in ((CFG, D), (full, 7168)):
        assert tmla.mla_param_count(cfg, d) == jmla.mla_param_count(cfg, d)
        for tokens, seq in ((1, 544), (24, 12), (4096, 512)):
            assert tmla.mla_fwd_flops(cfg, d, tokens, seq) == \
                jmla.mla_fwd_flops(cfg, d, tokens, seq)
    assert sum(v.numel() for v in ours.values()) == \
        3 * tmla.mla_param_count(CFG, D)


@pytest.mark.parametrize("q_chunk", [1024, 4], ids=["one-block", "blocks"])
def test_apply_full_and_grads_match_reference(layer, q_chunk):
    jp, tp = layer
    b, s = 2, 10
    x, r = _rand(2, b, s, D), _rand(3, b, s, D)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))

    def jfn(p, x):
        return jmla.mla_apply_full(p, CFG, x, jnp.asarray(pos),
                                   q_chunk=q_chunk)

    (_, (jout, jcache)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        lambda p, x: (jnp.sum(jfn(p, x)[0] * r), jfn(p, x)),
        argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tp = tree_map(lambda t: t.clone().requires_grad_(), tp)
    tx = torch.from_numpy(x).requires_grad_()
    out, cache = tmla.mla_apply_full(tp, CFG, tx, torch.from_numpy(pos),
                                     q_chunk=q_chunk)
    _close(out, jout, LAYER_TOL)
    assert cache.keys() == jcache.keys() == {"c_kv", "k_rope"}
    for k in cache:
        _close(cache[k], jcache[k], LAYER_TOL)
    (out * torch.from_numpy(r)).sum().backward()
    _close(tx.grad, jgx, LAYER_TOL)
    got, want = _flat(tree_map(lambda t: t.grad, tp)), _flat(jgp)
    assert got.keys() == want.keys()
    for k in got:
        _close(got[k], want[k], LAYER_TOL)


def _cache(seed, b, s):
    return {"c_kv": _rand(seed, b, s, CFG.kv_lora_rank),
            "k_rope": _rand(seed + 1, b, s, CFG.qk_rope_dim)}


@pytest.mark.parametrize("per_lane", [False, True],
                         ids=["one-position", "per-lane"])
def test_decode_matches_reference(layer, per_lane):
    jp, tp = layer
    b, max_seq = 3, 12
    x = _rand(4, b, 1, D)
    cache = _cache(5, b, max_seq)
    pos = np.array([7, 3, 11] if per_lane else [7, 7, 7], np.int32)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    out, got = tmla.mla_decode(tp, CFG, torch.from_numpy(x), tcache,
                               torch.from_numpy(pos))
    assert got is tcache                        # written in place
    # the reference writes every lane at pos[0]: hold each lane to a
    # one-lane call at its own position
    decode = jax.jit(jmla.mla_decode, static_argnums=1)
    for i in range(b):
        jout, jc = decode(
            jp, CFG, jnp.asarray(x[i:i + 1]),
            {k: jnp.asarray(v[i:i + 1]) for k, v in cache.items()},
            jnp.asarray(pos[i:i + 1]))
        _close(out[i:i + 1], jout, LAYER_TOL)
        for k in cache:
            _close(got[k][i:i + 1], jc[k], LAYER_TOL)


def test_paged_decode_matches_reference(layer):
    jp, tp = layer
    slots, ps, mb = 3, 4, 3
    n_pages = 1 + slots * mb
    rng = np.random.default_rng(6)
    pages = _cache(7, n_pages, ps)
    bt = rng.permutation(np.arange(1, n_pages)).reshape(slots, mb) \
        .astype(np.int32)
    pos = np.array([5, 11, 0], np.int32)
    active = np.array([True, True, False])
    x = _rand(8, slots, 1, D)
    jout, jpages = jax.jit(jmla.mla_decode_paged, static_argnums=1)(
        jp, CFG, jnp.asarray(x), jax.tree.map(jnp.asarray, pages),
        jnp.asarray(bt), jnp.asarray(pos), jnp.asarray(active))
    tpages = {k: torch.from_numpy(v.copy()) for k, v in pages.items()}
    out, got = tmla.mla_decode_paged(
        tp, CFG, torch.from_numpy(x), tpages, torch.from_numpy(bt),
        torch.from_numpy(pos), torch.from_numpy(active))
    assert got is tpages
    _close(out, jout, LAYER_TOL)
    for k in pages:         # page 0 is the trash page: written, never read
        _close(got[k][1:], np.asarray(jpages[k])[1:], LAYER_TOL)


@pytest.mark.parametrize("backend", ["contiguous", "paged"])
def test_absorbed_decode_equals_expanded_forward(layer, backend):
    """Token ``t`` decoded against the latents of ``[0, t)`` gives the
    expanded forward's output at ``t`` (the check ``chip_smoke.py``
    makes at published widths)."""
    _, tp = layer
    b, s, ps = 2, 9, 4
    x = torch.from_numpy(_rand(9, b, s, D))
    pos = torch.arange(s).expand(b, s)
    with torch.no_grad():
        full, lat = tmla.mla_apply_full(tp, CFG, x, pos)
        t = s - 1
        step_pos = torch.full((b,), t, dtype=torch.int32)
        cache = {k: torch.zeros(b, 12, v.shape[-1]) for k, v in lat.items()}
        for k, v in lat.items():
            cache[k][:, :t] = v[:, :t]
        if backend == "contiguous":
            out, _ = tmla.mla_decode(tp, CFG, x[:, t:t + 1], cache, step_pos)
        else:
            bt = torch.arange(1, 1 + b * 3, dtype=torch.int32).reshape(b, 3)
            pages = {k: torch.cat([torch.zeros(1, ps, v.shape[-1]),
                                   v.reshape(b * 3, ps, -1)])
                     for k, v in cache.items()}
            out, _ = tmla.mla_decode_paged(tp, CFG, x[:, t:t + 1], pages,
                                           bt, step_pos,
                                           torch.ones(b, dtype=torch.bool))
    _close(out[:, 0], full[:, t], LAYER_TOL)


# ---------------------------------------------------------------- the model

@pytest.fixture(scope="module")
def model(reference):
    """dsv3 SMOKE on both sides, from the port's parameters."""
    tm, jm = get_arch(ARCH).make_smoke(), jget_arch(ARCH).make_smoke()
    tp = tm.init(torch.Generator().manual_seed(0))
    return jm, params_to_numpy(tp), tm, tp


def test_mtp_loss_and_grads_match(model):
    jm, jp, tm, tp = model
    b, s = 2, 12
    h = _rand(10, b, s, D)
    toks = _tokens(11, (b, s), tm.cfg.vocab)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    jloss, (jgp, jgh) = jax.jit(jax.value_and_grad(
        lambda p, h: jm._mtp_loss(p, h, jbatch), argnums=(0, 1)))(
        jp, jnp.asarray(h))
    tp = tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
    th = torch.from_numpy(h).requires_grad_()
    t = torch.from_numpy(toks).long()
    loss = tm._mtp_loss(tp, th, {"tokens": t, "labels": t})
    loss.backward()
    _close(loss, jloss)
    _close(th.grad, jgh)
    got, want = _flat(tree_map(lambda x: x.grad, tp)), _flat(jgp)
    for k in want:      # the trunk's blocks get no gradient from the term
        if k.startswith(("/embed", "/mtp", "/head")):
            _close(got[k], want[k])
        else:
            assert got[k] is None and not np.asarray(want[k]).any(), k


@pytest.mark.parametrize("which", ["SMOKE", "CONFIG"])
def test_layout_costs_and_fingerprint_match(which):
    from repro.api import JobConfig as JJobConfig
    from repro.api import Session as JSession
    smoke = which == "SMOKE"
    make = "make_smoke" if smoke else "make_model"
    tm, jm = getattr(get_arch(ARCH), make)(), getattr(jget_arch(ARCH),
                                                      make)()
    entries = [dataclasses.astuple(e) for e in tm.unit_layout().entries]
    assert entries == [dataclasses.astuple(e)
                       for e in jm.unit_layout().entries]
    assert entries[-2:] == [("mtp", "mtp", None), ("head", "head", None)]
    for mode in ("train", "decode"):
        assert tm.layer_costs(8, 512, mode=mode) == \
            jm.layer_costs(8, 512, mode=mode)
    assert tm.param_count() == jm.param_count() == \
        (208_128 if smoke else 682_636_457_984)
    assert tm.active_param_count() == jm.active_param_count()
    job = dict(arch=ARCH, smoke=smoke, workers=4, period=3)
    assert Session(JobConfig(**job), device="cpu").plan.fingerprint() == \
        JSession(JJobConfig(**job)).plan.fingerprint()


def test_sync_units_on_the_mtp_group_match(model):
    """The unstacked ``mtp`` group is one unit, averaged whole, as
    ``embed`` and ``head`` are."""
    from repro.core.partial_sync import sync_units as jsync_units
    jm, jp, tm, tp = model
    layout = tm.unit_layout()
    units = [layout.names.index(n) for n in ("mtp", "layer_1", "head")]
    stacked = worker_stack(tp, 2)
    for leaf in _flat(stacked).values():
        leaf[1].add_(torch.from_numpy(_rand(12, *leaf.shape[1:])))
    start = params_to_numpy(tree_map(torch.clone, stacked))
    want = jax.jit(jsync_units, static_argnums=(1, 2))(
        jax.tree.map(jnp.asarray, start), tuple(units), jm.unit_layout())
    got = sync_units(stacked, units, layout)
    got, want, start = _flat(got), _flat(want), _flat(start)
    for k in got:
        _close(got[k], want[k], LAYER_TOL)
        moved = not np.array_equal(_np(got[k]), start[k])
        assert moved == k.startswith(("/mtp", "/head", "/blocks")), k


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


@pytest.mark.parametrize("cfg", [dict(), dict(kv_backend="paged",
                                              page_size=8)],
                         ids=["contiguous", "paged"])
def test_engine_matches_jax_engine(model, cfg):
    from repro.serve import EngineConfig as JConfig
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JEngine
    jm, jp, tm, tp = model
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

def test_session_fit_matches_jax_per_step(model):
    from repro.api import JobConfig as JJobConfig
    from repro.api import Session as JSession
    from repro.data import MarkovCorpus as JMarkovCorpus
    jm, jp, tm, tp = model

    class Given(JDecoderLM):             # the JAX session starts from tp
        def init(self, key):
            return jax.tree.map(jnp.asarray, jp)

    job = dict(arch=ARCH, smoke=True, algo="dreamddp", workers=2, period=2,
               seq=16, batch_per_worker=2, lr=3e-3, warmup_steps=2,
               decay_steps=50)
    js = JSession(JJobConfig(**job, fused_period=False),
                  model=Given(jm.cfg))
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
                 params=tree_map(torch.clone, tp), device="cpu")
    assert ts.plan.fingerprint() == js.plan.fingerprint()
    ts.fit(4)
    np.testing.assert_allclose([h["loss"] for h in ts.history],
                               [h["loss"] for h in js.history], rtol=1e-5)


# ---------------------------------------------------------------- the card

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the decode block is a CUDA graph)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["paged", "contiguous"])
def test_mla_decode_block_graph_is_bitwise_the_eager_block(cuda, backend):
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
    assert graph.block_stats.graphs == 2 and graph.block_stats.replays > 0
    assert graph.block_stats.kernel_launches() == {}


@pytest.mark.gpu
def test_mla_engine_holds_no_paged_kernel_scratch(cuda):
    model = get_arch(ARCH).make_smoke()
    params = model.init(torch.Generator("cuda").manual_seed(0))
    before = (paged_attention.launches, flash_attention.launches)
    engine = ServeEngine(model, params, EngineConfig(
        max_batch=4, max_seq=32, decode_block=4, kv_backend="paged",
        page_size=8))
    assert engine._attn_scratch is None
    comps = engine.generate([Request(tokens=[1, 2, 3, 4, 5],
                                     max_new_tokens=6)])
    assert len(comps[0].tokens) == 6
    assert (paged_attention.launches, flash_attention.launches) == before
