"""The port's serving API against the JAX package's, on the CPU.

* **Decode block** — the block body (the function a CUDA graph replays
  on the card) reads nothing back to the host; with a block wider than
  every remaining budget, its masked ticks are counted and every
  ``EngineStats`` counter still equals the JAX engine's early exit;
  seeded sampling does not depend on the block width.
* **Engine control** — ``compile_stats`` equal to the JAX engine's under
  every prefill key (the reference's jit-cache sizes; ``decode_block``
  counts the port's two body variants against the reference's one
  executable) and unchanged by admission into freed slots, page churn and
  ``reset(params=...)``; ``drain``; ``reset(params=...)`` keeps every
  parameter's address and gives a fresh engine's streams.
* **Array-form ``generate`` and ``InferenceSession``** — shape, EOS
  padding, ``max_new_tokens <= 0``, the shim's warning and ``max_seq``
  growth, each equal to the JAX package's output.
* **``Session.serve()``** — the cases of ``tests/test_api.py``:
  memoized engines, a busy engine refused, the engine's own copy of the
  parameters, and greedy streams equal to the JAX session's from the
  same initial state.

Discrete outputs are compared exactly (greedy argmax over float32
logits of the same params).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.api import InferenceSession as JInferenceSession  # noqa: E402
from repro.api import JobConfig as JJobConfig  # noqa: E402
from repro.api import Session as JSession  # noqa: E402
from repro.configs import get_arch  # noqa: E402
from repro.models.transformer import DecoderLM as JDecoderLM  # noqa: E402
from repro.models.transformer import LMConfig as JLMConfig  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.api import InferenceSession, JobConfig, Session  # noqa: E402
from repro_torch.configs import granite_3_2b, mamba2_780m  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.partial_sync import worker_unstack  # noqa: E402
from repro_torch.models.mamba2 import Mamba2LM  # noqa: E402
from repro_torch.models.transformer import DecoderLM, LMConfig  # noqa: E402
from repro_torch.serve import (EngineConfig, Request,  # noqa: E402
                               SamplingParams, ServeEngine)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(1)

_PROMPT_LENS = (6, 6, 9, 12, 6, 3)
_BUDGETS = (5, 3, 7, 2, 6, 4)
_COUNTERS = ("requests_completed", "prompt_tokens", "generated_tokens",
             "decode_ticks", "prefill_batches", "admit_ticks",
             "slot_ticks_active", "slot_ticks_total")
_TINY = dict(name="t", n_layers=4, d_model=48, n_heads=4, n_kv_heads=2,
             d_ff=96, vocab=64, param_dtype="float32", remat=False)


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in _PROMPT_LENS]


def _cfg(backend, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq", 32)
    kw.setdefault("decode_block", 4)
    if backend == "paged":
        kw.setdefault("kv_backend", "paged")
        kw.setdefault("page_size", 8)
    return kw


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX model, JAX params, port model, the same params)."""
    out = {}
    for arch, port_cls, cfg in (("granite-3-2b", DecoderLM,
                                 granite_3_2b.SMOKE),
                                ("mamba2-780m", Mamba2LM,
                                 mamba2_780m.SMOKE)):
        jm = get_arch(arch).make_smoke()
        jp = jm.init(jax.random.PRNGKey(0))
        out[arch] = (jm, jp, port_cls(cfg),
                     params_from_numpy(jax.device_get(jp), "cpu"))
    return out


def _run(engine, request_cls, eos=None, eos_req=2):
    """The workload through ``engine`` step by step (request ``eos_req``
    stops at ``eos``): (tokens, finish reasons, completion order,
    counters)."""
    prompts = _prompts(engine.model.cfg.vocab)
    for i, (p, g) in enumerate(zip(prompts, _BUDGETS, strict=True)):
        engine.submit(request_cls(tokens=p, max_new_tokens=g, request_id=i,
                                  eos_id=eos if i == eos_req else None))
    order, comps = [], {}
    while engine.has_work:
        done = engine.step()
        order.append(sorted(c.request_id for c in done))
        comps.update((c.request_id, c) for c in done)
    st = engine.stats
    return ({i: c.tokens for i, c in comps.items()},
            {i: c.finish_reason for i, c in comps.items()}, order,
            {k: getattr(st, k) for k in _COUNTERS})


def _engines(models, arch, **cfg):
    jm, jp, tm, tp = models[arch]
    return (ServeEngine(tm, tp, EngineConfig(**cfg), device="cpu"),
            JServeEngine(jm, jp, JEngineConfig(**cfg)))


# ------------------------------------------------------------ decode block

_WIDE = [("granite-3-2b", "contiguous", True),
         ("granite-3-2b", "paged", True),
         ("granite-3-2b", "paged", False),
         ("mamba2-780m", "contiguous", True)]


@pytest.mark.parametrize("arch,backend,batched", _WIDE,
                         ids=["dense-contiguous", "dense-paged",
                              "dense-paged-serial", "mamba2-contiguous"])
def test_wide_block_with_mid_block_eos_matches_jax(models, arch, backend,
                                                   batched):
    """decode_block 16 exceeds every budget (<= 7): each block ends in
    fully masked ticks, and one request hits EOS in the middle of its
    first block: the first request whose greedy stream, from its third
    token on, emits a token it has not emitted before (the smoke
    models repeat themselves), stopped there."""
    cfg = _cfg(backend, decode_block=16, batched_admission=batched)
    probe = ServeEngine(models[arch][2], models[arch][3],
                        EngineConfig(**cfg), device="cpu")
    streams = _run(probe, Request)[0]
    req, stop = next((i, j) for i, s in sorted(streams.items())
                     for j in range(2, len(s)) if s[j] not in s[:j])
    eos = streams[req][stop]
    ours, theirs = _engines(models, arch, **cfg)
    got = _run(ours, Request, eos, req)
    assert got == _run(theirs, JRequest, eos, req)
    assert got[1][req] == "stop" and got[0][req] == streams[req][:stop + 1]
    masked = ours.block_stats.masked_ticks(16)
    assert masked > 0
    assert ours.block_stats.ticks_run * 4 == got[3]["slot_ticks_total"]
    assert ours.block_stats.replays == got[3]["decode_ticks"]
    assert ours.block_stats.graphs == 0                # no graph on the CPU
    assert ours.block_stats.kernel_launches() == {}


def test_block_body_reads_nothing_back_to_the_host(models, monkeypatch):
    """What a CUDA graph cannot capture fails here: the body, run with
    live lanes on both variants, may not turn a tensor into a Python
    value or build one from host data."""
    tm, tp = models["granite-3-2b"][2:]
    for backend in ("paged", "contiguous"):
        eng = ServeEngine(tm, tp, EngineConfig(**_cfg(backend)),
                          device="cpu")
        for i, p in enumerate(_prompts(tm.cfg.vocab)[:4]):
            eng.submit(Request(tokens=p, max_new_tokens=20, sampling=(
                SamplingParams(temperature=1.0, seed=i) if i % 2
                else SamplingParams())))
        eng.step()
        variant = eng._load_block_inputs()
        assert variant == "sampled"

        def host_read(*a, **k):
            raise AssertionError("host read inside the decode block")

        with monkeypatch.context() as m:
            for name in ("item", "tolist", "numpy", "cpu", "__bool__",
                         "__int__", "__float__", "__index__"):
                m.setattr(torch.Tensor, name, host_read)
            m.setattr(torch, "tensor", host_read)
            for name in ("greedy", "sampled"):
                eng._variants[name]()
        assert bool(eng._state.active.any())


def test_seeded_sampling_does_not_depend_on_the_block_width(models):
    """Each sampling lane draws its block's uniforms in tick order before
    the block, so its stream is the one a draw per tick gives."""
    tm, tp = models["granite-3-2b"][2:]
    prompt = _prompts(tm.cfg.vocab)[0]
    sp = SamplingParams(temperature=3.0, top_k=50, seed=42)
    streams = []
    for block in (1, 3, 16):
        eng = ServeEngine(tm, tp, EngineConfig(**_cfg(
            "paged", decode_block=block)), device="cpu")
        reqs = [Request(tokens=prompt, max_new_tokens=9, sampling=sp),
                Request(tokens=prompt[:4], max_new_tokens=2)]
        streams.append(eng.generate(reqs)[0].tokens)
        assert eng.block_stats.blocks["sampled"] > 0
    assert streams[0] == streams[1] == streams[2]


# ------------------------------------------------------------ control

_CONFIGS = [("contiguous", True, None), ("contiguous", False, None),
            ("paged", True, None), ("paged", False, None),
            ("paged", True, 8), ("contiguous", False, 4)]


@pytest.mark.parametrize("backend,batched,chunk", _CONFIGS,
                         ids=["contiguous-batched", "contiguous-serial",
                              "paged-batched", "paged-serial",
                              "paged-chunked", "contiguous-serial-chunked"])
def test_compile_stats_match_jax(models, backend, batched, chunk):
    cfg = _cfg(backend, batched_admission=batched, prefill_chunk=chunk)
    ours, theirs = _engines(models, "granite-3-2b", **cfg)
    _run(ours, Request)
    _run(theirs, JRequest)
    got, want = ours.compile_stats(), theirs.compile_stats()
    assert got == {**want, "decode_block": 2}
    # a second round: admission into freed slots, page churn, reset
    ours.reset(params=models["granite-3-2b"][3])
    _run(ours, Request)
    assert ours.compile_stats() == got


def test_batched_and_paged_compile_stats_invariants(models):
    """The assertions of tests/test_batched_admission.py:156-170 and
    tests/test_paged_engine.py:111-114,160-161 on the port."""
    tm, tp = models["granite-3-2b"][2:]
    eng = ServeEngine(tm, tp, EngineConfig(**_cfg("contiguous")),
                      device="cpu")
    reqs = lambda: [Request(tokens=p, max_new_tokens=3)       # noqa: E731
                    for p in _prompts(tm.cfg.vocab, seed=1)[:4]]
    eng.generate(reqs())
    stats = eng.compile_stats()
    assert stats["prefill"] == stats["refeed"] == 0
    assert stats["first_sample"] == 0 and stats["prefill_batched"] > 0
    eng.generate(reqs())
    assert eng.compile_stats() == stats, "same-shape round recompiled"
    eng = ServeEngine(tm, tp, EngineConfig(**_cfg(
        "paged", prefill_chunk=8, max_batch=1)), device="cpu")
    lens = (5, 8, 11)
    first = eng.generate([Request(tokens=list(range(1, n + 1)),
                                  max_new_tokens=4) for n in lens])
    stats = eng.compile_stats()
    assert stats["paged_admit"] == 1 and stats["paged_admit_refeed"] == 2
    again = eng.generate([Request(tokens=list(range(1, n + 1)),
                                  max_new_tokens=4) for n in lens])
    assert eng.compile_stats() == stats
    assert [c.tokens for c in first] == [c.tokens for c in again]


@pytest.mark.parametrize("arch,backend",
                         [("granite-3-2b", "paged"),
                          ("granite-3-2b", "contiguous"),
                          ("mamba2-780m", "contiguous")],
                         ids=["dense-paged", "dense-contiguous",
                              "mamba2-contiguous"])
def test_reset_params_keeps_addresses_and_matches_a_fresh_engine(
        models, arch, backend):
    tm, tp = models[arch][2:]
    new = tm.init(torch.Generator().manual_seed(7))
    eng = ServeEngine(tm, _clone(tp), EngineConfig(**_cfg(backend)),
                      device="cpu")
    ptrs = [t.data_ptr() for t in tree_leaves(eng.params)]
    state_ptrs = [t.data_ptr() for t in vars(eng._state).values()]
    before = _run(eng, Request)
    eng.reset(params=new)
    assert [t.data_ptr() for t in tree_leaves(eng.params)] == ptrs
    assert [t.data_ptr() for t in vars(eng._state).values()] == state_ptrs
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(eng.params), tree_leaves(new), strict=True))
    after = _run(eng, Request)
    fresh = ServeEngine(tm, _clone(new), EngineConfig(**_cfg(backend)),
                        device="cpu")
    assert after == _run(fresh, Request)
    assert after[0] != before[0]
    with pytest.raises(ValueError, match="engine"):
        eng.reset(params={"embed": new["embed"]})


def _clone(tree):
    return tree_map(lambda x: x.clone(), tree)


def test_drain_and_reset_zero_the_state_in_place(models):
    tm, tp = models["granite-3-2b"][2:]
    eng = ServeEngine(tm, tp, EngineConfig(**_cfg("paged")), device="cpu")
    for p in _prompts(tm.cfg.vocab):
        eng.submit(Request(tokens=p, max_new_tokens=5))
    first = eng.step()
    assert eng.has_work and int(eng._state.pos.max()) > 0
    done = eng.drain()
    assert len(first) + len(done) == 6 and not eng.has_work
    assert int(eng._state.pos.abs().sum()) == 0
    assert eng._state.eos.tolist() == [-1] * 4
    eng.submit(Request(tokens=[1, 2, 3], max_new_tokens=3))
    eng.step()
    eng.reset()
    assert not eng.has_work and eng.stats.requests_completed == 0
    assert eng.block_stats.replays == 0
    assert not bool(eng._state.active.any())
    assert eng.pool.pages_in_use == 0


# ------------------------------------------------------ array generate

@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-780m"])
def test_array_generate_matches_jax(models, arch):
    jm, jp, tm, tp = models[arch]
    cfg = _cfg("contiguous", max_batch=2, max_seq=64)
    ours = ServeEngine(tm, tp, EngineConfig(**cfg), device="cpu")
    theirs = JServeEngine(jm, jp, JEngineConfig(**cfg))
    toks = np.random.default_rng(3).integers(0, tm.cfg.vocab, (3, 8))
    got = ours.generate(torch.from_numpy(toks), 6)
    assert got.shape == (3, 6) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(theirs.generate(toks, 6)))
    # an EOS that row 0 meets at its second token: padded with it
    eos = int(got[0, 1])
    early = ours.generate(toks, 6, eos_id=eos)
    np.testing.assert_array_equal(
        early.numpy(), np.asarray(theirs.generate(toks, 6, eos_id=eos)))
    row = early[0].tolist()
    assert row[:2] == got[0, :2].tolist() and set(row[1:]) == {eos}
    assert ours.generate(toks, 0).shape == (3, 0)
    assert ours.generate(toks, -2).shape == (3, 0)


def test_inference_session_shim_warns_grows_and_matches_jax(models):
    jm, jp, tm, tp = models["granite-3-2b"]
    toks = np.random.default_rng(4).integers(0, tm.cfg.vocab, (2, 14))
    with pytest.warns(DeprecationWarning, match="ServeEngine"):
        shim = InferenceSession(tm, tp, config=EngineConfig(
            max_batch=2, max_seq=16), device="cpu")
    out = shim.generate(torch.from_numpy(toks), max_new_tokens=8)  # 22 > 16
    assert out.shape == (2, 8) and shim.engine.config.max_seq == 22
    with pytest.warns(DeprecationWarning):
        jshim = JInferenceSession(jm, jp, config=JEngineConfig(
            max_batch=2, max_seq=16))
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jshim.generate(toks, 8)))
    eng = shim.engine
    assert torch.equal(shim.generate(toks, 4),
                       eng.reset(params=eng.params).generate(toks, 4))
    with pytest.warns(DeprecationWarning):
        paged = InferenceSession(tm, tp, config=EngineConfig(
            max_batch=2, max_seq=16, kv_backend="paged", page_size=8),
            device="cpu")
    assert torch.equal(paged.generate(toks, 8), out)
    assert paged.engine.config.max_seq == 24


# ------------------------------------------------------ Session.serve()

def _session(workers=2, **kw):
    return Session(JobConfig(algo="dreamddp", workers=workers, period=2,
                             seq=16, batch_per_worker=2, warmup_steps=2,
                             decay_steps=50, **kw),
                   model=DecoderLM(LMConfig(**_TINY)), device="cpu")


def test_session_serve_returns_engine_and_memoizes():
    sess = _session()
    sess.fit(2)
    cfg = EngineConfig(max_batch=2, max_seq=64)
    eng = sess.serve(config=cfg)
    assert isinstance(eng, ServeEngine) and eng.device.type == "cpu"
    toks = np.random.default_rng(0).integers(0, _TINY["vocab"], (2, 8))
    out = eng.generate(toks, 4)
    assert out.shape == (2, 4)
    assert int(out.min()) >= 0 and int(out.max()) < _TINY["vocab"]
    misses = eng.compile_stats()
    sess.fit(2)
    eng2 = sess.serve(config=cfg)
    assert eng2 is eng                     # memoized: nothing rebuilt
    assert eng2.generate(toks, 4).shape == (2, 4)
    assert eng2.compile_stats() == misses
    assert sess.serve(config=EngineConfig(max_batch=4, max_seq=64)) \
        is not eng
    assert sess.serve(config=cfg, worker=1) is not eng


def test_session_serve_refuses_to_reset_busy_engine():
    sess = _session()
    cfg = EngineConfig(max_batch=2, max_seq=64)
    eng = sess.serve(config=cfg)
    eng.submit(Request(tokens=[1, 2, 3], max_new_tokens=4))
    with pytest.raises(RuntimeError, match="drain"):
        sess.serve(config=cfg)
    assert len(eng.drain()) == 1
    assert sess.serve(config=cfg) is eng     # idle again: safe to reuse


def test_session_serve_holds_a_copy_taken_at_serve_time():
    sess = _session()
    before = _session().serve().params       # no state: the initial ones
    sess.fit(2)
    eng = sess.serve(worker=1)
    want = [t.clone() for t in tree_leaves(
        worker_unstack(sess.state.params, 1))]
    got = tree_leaves(eng.params)
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
    assert not all(torch.equal(a, b) for a, b in zip(
        got, tree_leaves(before), strict=True))
    sess.fit(2)                    # updates the state in place
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(eng.params), want, strict=True))
    assert sess.serve(worker=1) is eng
    now = tree_leaves(worker_unstack(sess.state.params, 1))
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(eng.params), now, strict=True))
    assert not all(torch.equal(a, b) for a, b in zip(now, want,
                                                     strict=True))


def test_session_serve_before_fit_uses_the_initial_params():
    fresh = _session().serve().params
    built = worker_unstack(_session().state.params, 0)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(fresh), tree_leaves(built), strict=True))


def test_session_serve_matches_jax_session_serve():
    jsess = JSession(JJobConfig(algo="dreamddp", workers=2, period=2,
                                seq=16, batch_per_worker=2),
                     model=JDecoderLM(JLMConfig(**_TINY)))
    init = jax.device_get(jsess.state.params)
    sess = _session()
    for t, a in zip(tree_leaves(sess.state.params), tree_leaves(init),
                    strict=True):
        t.copy_(torch.from_numpy(np.array(a)))
    toks = np.random.default_rng(5).integers(0, _TINY["vocab"], (3, 7))
    cfg = dict(max_batch=2, max_seq=32, decode_block=3)
    got = sess.serve(config=EngineConfig(**cfg)).generate(toks, 9)
    want = jsess.serve(config=JEngineConfig(**cfg)).generate(
        jnp.asarray(toks), 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
