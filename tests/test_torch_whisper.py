"""The port's Whisper encoder-decoder against the JAX package's
``WhisperModel``, on the CPU, at whisper-medium's ``SMOKE`` (2 encoder +
2 decoder layers, d_model 32, 4 heads of width 8, d_ff 64, vocab 256,
12 frames, 64 decoder positions, float32).

Parameters are the port's, carried to JAX as numpy (a JAX init would
cost seconds of CPU); frames and tokens are made with numpy from a seed.

* **Structure** — configs, the init's keys, shapes and dtypes,
  ``unit_layout``, ``layer_costs``, ``param_count`` (792,032,256 at full
  width) and the plan fingerprint **exactly**.
* **The model** — ``encode``, logits, the loss and its gradients (with
  and without remat): ``TOL`` (float32 sums in another order over a few
  layers).  Prefill logits and every cache leaf for two lanes, then 6
  decode steps with the lanes at their own positions, each lane held to
  a one-lane reference call at its position (the reference writes every
  lane at ``pos[0]``): ``TOL``.  Prefill then decode equals the full
  forward, as ``tests/test_models.py`` holds the reference.  Prefill
  calls the flash wrapper for every attention, decode the paged wrapper
  over the lanes seen as pages.
* **Serving** — greedy streams, finish reasons, completion order and
  every ``EngineStats`` counter **equal** to the JAX ``ServeEngine``'s on
  the contiguous backend, batched and serial admission, with mid-stream
  admission and a request stopping at an EOS; the paged backend refused
  by both; a request past the decoder's positions refused; the CLI,
  ``Session.serve`` and ``InferenceSession``.

On the card (``-m gpu``; skipped without CUDA, and run there without
JAX): the decode block as a CUDA graph replay, bitwise the eager block,
through the paged kernel over the self and cross lanes.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
try:
    import jax
    jnp = jax.numpy
    from repro.configs import get_arch as jget_arch
    from repro.configs import whisper_medium as jax_wh
    from repro.models import whisper as jwhisper
except ImportError:     # the card's machine has no JAX: the gpu tests run
    jax = None

from repro_torch.api import InferenceSession, JobConfig, Session  # noqa: E402
from repro_torch.configs import get_arch, whisper_medium  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.models.whisper import WhisperModel  # noqa: E402
from repro_torch.serve import (EngineConfig, NaiveLoop, Request,  # noqa: E402
                               ServeEngine, naive_generate)
from repro_torch.tree import tree_map  # noqa: E402

torch.set_num_threads(1)

ARCH = "whisper-medium"
SMOKE = whisper_medium.SMOKE
FULL_PARAMS = 792_032_256
TOL = 1e-5          # float32 sums in another order over a few layers


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


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, SMOKE.vocab, shape,
                                                dtype=np.int32)


def _frames(seed, b):
    return np.random.default_rng(seed).standard_normal(
        (b, SMOKE.n_frames, SMOKE.d_model)).astype(np.float32)


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
    tm = WhisperModel(SMOKE)
    tp = tm.init(torch.Generator().manual_seed(0))
    # a decoder position table and biases that are not all alike, so a
    # position or bias the port dropped would show
    g = torch.Generator().manual_seed(1)
    for k, v in _flat(tp).items():
        if k.endswith("/b") or k.endswith("/bias"):
            v.copy_(0.1 * torch.randn(v.shape, generator=g))
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))
    return jwhisper.WhisperModel(jax_wh.SMOKE), jp, tm, tp


# ---------------------------------------------------------------- structure

@pytest.mark.parametrize("name", ["CONFIG", "SMOKE"])
def test_config_and_arch_match_reference(name):
    ours, theirs = (getattr(m, name) for m in (whisper_medium, jax_wh))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    arch = get_arch(ARCH)
    make = "make_model" if name == "CONFIG" else "make_smoke"
    assert isinstance(getattr(arch, make)(), WhisperModel)
    assert getattr(arch, make)().cfg == ours
    assert arch.family == jget_arch(ARCH).family == "audio"
    assert arch.frontend == jget_arch(ARCH).frontend == "audio"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_layout_and_dtypes_match_reference(dtype):
    cfg = dataclasses.replace(SMOKE, param_dtype=dtype)
    ours = _flat(WhisperModel(cfg).init(torch.Generator().manual_seed(0)))
    jcfg = dataclasses.replace(jax_wh.SMOKE, param_dtype=dtype)
    theirs = _flat(jax.eval_shape(jwhisper.WhisperModel(jcfg).init,
                                  jax.random.PRNGKey(0)))
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert tuple(ours[k].shape) == theirs[k].shape, k
        assert str(ours[k].dtype).removeprefix("torch.") \
            == theirs[k].dtype.name, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_params_round_trip_exactly(dtype):
    """A tree of the reference's keys, shapes and dtypes (bfloat16 as
    ml_dtypes gives it) comes into the port and back bitwise, each leaf
    keeping its dtype."""
    jcfg = dataclasses.replace(jax_wh.SMOKE, param_dtype=dtype)
    shapes = jax.eval_shape(jwhisper.WhisperModel(jcfg).init,
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        a.dtype), shapes)
    ours = params_from_numpy(tree, "cpu")
    for k, v in _flat(ours).items():
        assert str(v.dtype).removeprefix("torch.") == dtype, k
    back, want = _flat(params_to_numpy(ours)), _flat(tree)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], np.asarray(want[k],
                                                          np.float32))


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
    for mode in ("train", "decode"):
        assert tm.layer_costs(8, 448, mode=mode) == \
            jm.layer_costs(8, 448, mode=mode)
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


# ---------------------------------------------------------------- the model

def test_encode_and_logits_match(model):
    jm, jp, tm, tp = model
    tok, frames = _tokens(1, (2, 17)), _frames(1, 2)
    with torch.no_grad():
        enc = tm.encode(tp, torch.from_numpy(frames))
        kern = tm.encode(tp, torch.from_numpy(frames), kernel=True)
        ours = tm.apply(tp, torch.from_numpy(tok), torch.from_numpy(frames))
    _close(enc, jax.jit(jm.encode)(jp, jnp.asarray(frames)))
    _close(kern, enc)
    _close(ours, jax.jit(jm.apply)(jp, jnp.asarray(tok),
                                   jnp.asarray(frames)))


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax_grad(model, remat):
    jm, jp, _, tp = model
    tm = WhisperModel(dataclasses.replace(SMOKE, remat=remat))
    tok = _tokens(2, (2, 15))
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1),
             "frames": _frames(2, 2)}
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    loss = tm.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    _close(loss, jloss)
    ours, theirs = _flat(tp), _flat(jax.device_get(jgrads))
    assert ours.keys() == theirs.keys()
    for k in ours:
        _close(ours[k].grad, theirs[k])


def test_prefill_and_decode_match_per_lane(model):
    """Two lanes prefilled apart (prompts of 5 and 11), each prefill's
    logits and every cache leaf held to the reference's; then 6 decode
    steps of both lanes together, each at its own position, every lane
    held to a one-lane reference call, logits and cache leaves."""
    jm, jp, tm, tp = model
    depth = 24
    lens = (5, 11)
    jprefill = jax.jit(jm.prefill)
    jdecode = jax.jit(jm.decode_step)
    lanes, jcaches = [], []
    for i, n in enumerate(lens):
        tok, frames = _tokens(3 + i, (1, n)), _frames(3 + i, 1)
        with torch.no_grad():
            lg, cache = tm.prefill(tp, torch.from_numpy(tok),
                                   tm.init_cache(1, depth, device="cpu"),
                                   torch.from_numpy(frames))
        jlg, jcache = jprefill(jp, jnp.asarray(tok), jm.init_cache(1, depth),
                               jnp.asarray(frames))
        _close(lg, jlg)
        ours, theirs = _flat(cache), _flat(jax.device_get(jcache))
        assert ours.keys() == theirs.keys()
        for k in ours:
            assert tuple(ours[k].shape) == theirs[k].shape, k
            _close(ours[k], theirs[k])
        lanes.append(cache)
        jcaches.append(jcache)
    cache = tree_map(lambda a, b: torch.cat([a, b], 1), *lanes)
    rng = np.random.default_rng(7)
    pos = np.array(lens, np.int32)
    for _ in range(6):
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
            ours = _flat(tree_map(lambda t: t[:, b:b + 1], cache))
            theirs = _flat(jax.device_get(jcaches[b]))
            for k in ours:
                _close(ours[k], theirs[k])
        pos += 1


def test_smoke_decode_matches_full_forward(model):
    """As ``tests/test_models.py`` holds the reference: prefill's last
    logits and one greedy decode step equal the full forward's."""
    _, _, tm, tp = model
    b, s = 2, 12
    toks = torch.from_numpy(_tokens(4, (b, s))).long()
    frames = torch.from_numpy(_frames(4, b))
    with torch.no_grad():
        cache = tm.init_cache(b, s + 4, device="cpu")
        lg, cache = tm.prefill(tp, toks, cache, frames)
        _close(lg[:, 0], tm.apply(tp, toks, frames)[:, -1])
        nxt = lg.argmax(-1)
        lg2, cache = tm.decode_step(tp, cache, nxt,
                                    torch.full((b,), s, dtype=torch.int32))
        full2 = tm.apply(tp, torch.cat([toks, nxt], 1), frames)
    _close(lg2[:, 0], full2[:, -1])


def test_prefill_runs_flash_and_decode_the_paged_wrapper(model,
                                                          monkeypatch):
    """Every attention of a prefill calls the flash wrapper (encoder and
    cross non-causal, decoder self causal) and every one of a decode
    step the paged wrapper over the lanes seen as pages (self at ``pos +
    1`` keys, cross at ``n_frames``); on the CPU they run their plain
    versions and count no launch."""
    _, _, tm, tp = model
    import repro_torch.models.whisper as wh
    calls = []

    def flash_spy(q, k, v, *, causal):
        calls.append(("flash", causal, k.shape[1]))
        return flash_attention(q, k, v, causal=causal)

    def paged_spy(q, kp, vp, table, kv_len, *, scratch):
        calls.append(("paged", kp.shape[1], tuple(table.shape),
                      kv_len.tolist()))
        return paged_attention(q, kp, vp, table, kv_len, scratch=scratch)

    monkeypatch.setattr(wh, "flash_attention", flash_spy)
    monkeypatch.setattr(wh, "paged_attention", paged_spy)
    launches = (flash_attention.launches, paged_attention.launches)
    cache = tm.init_cache(2, 24, device="cpu")
    nf = SMOKE.n_frames
    with torch.no_grad():
        tm.prefill(tp, torch.from_numpy(_tokens(5, (2, 7))), cache,
                   torch.from_numpy(_frames(5, 2)))
        tm.decode_step(tp, cache, torch.from_numpy(_tokens(6, (2, 1))),
                       torch.tensor([7, 9], dtype=torch.int32))
    enc, dec = SMOKE.n_enc_layers, SMOKE.n_dec_layers
    assert calls == [("flash", False, nf)] * enc \
        + [("flash", True, 7), ("flash", False, nf)] * dec \
        + [("paged", 8, (2, 3), [8, 10]),
           ("paged", 4, (2, 3), [nf, nf])] * dec
    assert (flash_attention.launches, paged_attention.launches) == launches


# ---------------------------------------------------------------- serving

_PROMPT_LENS = (5, 11, 9, 3, 14, 6)
_BUDGETS = (9, 4, 7, 12, 3, 6)
_EOS_REQ = 2
_COUNTERS = ("requests_completed", "prompt_tokens", "generated_tokens",
             "decode_ticks", "prefill_batches", "admit_ticks",
             "slot_ticks_active", "slot_ticks_total")
_ENGINE = dict(max_batch=3, max_seq=32, decode_block=4)


def _requests(request_cls, eos_id):
    rng = np.random.default_rng(0)
    return [request_cls(
        tokens=rng.integers(0, SMOKE.vocab, n).tolist(), max_new_tokens=g,
        request_id=i, eos_id=eos_id if i == _EOS_REQ else None,
        extra=(rng.standard_normal((SMOKE.n_frames, SMOKE.d_model))
               .astype(np.float32),))
        for i, (n, g) in enumerate(zip(_PROMPT_LENS, _BUDGETS, strict=True))]


def _drive(engine, request_cls, eos_id):
    for r in _requests(request_cls, eos_id):
        engine.submit(r)
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


@pytest.fixture(scope="module")
def jax_runs(model):
    """The JAX engine's runs, batched and serial admission (one each for
    the module), with request 2 stopping at its 3rd greedy token."""
    from repro.serve import EngineConfig as JConfig
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JEngine
    jm, jp, tm, tp = model
    first = _drive(ServeEngine(tm, tp, EngineConfig(**_ENGINE),
                               device="cpu", frontend="audio"),
                   Request, None)
    eos_id = first["tokens"][_EOS_REQ][2]
    return eos_id, {batched: _drive(JEngine(jm, jp, JConfig(
        **_ENGINE, batched_admission=batched), frontend="audio"),
        JRequest, eos_id) for batched in (True, False)}


@pytest.mark.parametrize("batched", [True, False])
def test_engine_matches_jax_engine(model, jax_runs, batched):
    """Six requests over three slots, each with its own frames; one
    stops at an EOS."""
    _, _, tm, tp = model
    eos_id, theirs = jax_runs
    ours = _drive(ServeEngine(tm, tp, EngineConfig(
        **_ENGINE, batched_admission=batched), device="cpu",
        frontend="audio"), Request, eos_id)
    assert ours == theirs[batched]
    assert ours["finish"][_EOS_REQ] == "stop"


def test_naive_loop_matches_the_engine(model):
    _, _, tm, tp = model
    reqs = _requests(Request, None)[:3]
    comps = ServeEngine(tm, tp, EngineConfig(**_ENGINE), device="cpu",
                        frontend="audio").generate(reqs)
    loop = NaiveLoop(tm, tp, device="cpu", frontend="audio")
    for r, c in zip(reqs, comps, strict=True):
        want = loop.generate([r.tokens], r.max_new_tokens,
                             r.extra[0][None])[0].tolist()
        assert c.tokens == want
        assert naive_generate(tm, tp, [r.tokens], 2, r.extra[0][None],
                              frontend="audio", device="cpu")[0].tolist() \
            == want[:2]


def test_paged_backend_and_bad_requests_refused(model):
    from repro.serve import EngineConfig as JConfig
    from repro.serve import ServeEngine as JEngine
    jm, jp, tm, tp = model
    cfg = dict(max_batch=2, max_seq=32, kv_backend="paged", page_size=8)
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(tm, tp, EngineConfig(**cfg), device="cpu",
                    frontend="audio")
    with pytest.raises(ValueError, match="paged"):
        JEngine(jm, jp, JConfig(**cfg), frontend="audio")
    frames = (np.zeros((SMOKE.n_frames, SMOKE.d_model), np.float32),)
    eng = ServeEngine(tm, tp, EngineConfig(max_batch=1, max_seq=128),
                      device="cpu", frontend="audio")
    # the decoder's learned positions end at max_positions (64)
    with pytest.raises(ValueError, match="max_positions"):
        eng.submit(Request(tokens=list(range(60)), max_new_tokens=8,
                           extra=frames))
    with pytest.raises(ValueError, match="one frontend input"):
        eng.submit(Request(tokens=[1, 2], max_new_tokens=2))
    eng.submit(Request(tokens=list(range(60)), max_new_tokens=4,
                       extra=frames))


def test_cli_session_and_inference_session(model, capsys):
    from repro_torch.launch import serve as cli
    assert cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "4", "--gen", "3"]) == 0
    assert "requests=2" in capsys.readouterr().out
    _, _, tm, tp = model
    sess = Session(JobConfig(arch=ARCH, smoke=True), params=tp,
                   device="cpu")
    cfg = EngineConfig(**_ENGINE)
    engine = sess.serve(config=cfg)
    assert engine.frontend == "audio" and sess.serve(config=cfg) is engine
    tok = _tokens(8, (2, 6))
    frames = _frames(8, 2)
    got = engine.generate(tok, 5, frames)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        legacy = InferenceSession(tm, tp, frontend="audio", device="cpu")
        assert torch.equal(legacy.generate(tok, 5, frames), got)
    loop = NaiveLoop(tm, tp, device="cpu", frontend="audio")
    assert torch.equal(loop.generate(tok, 5, frames), got)


# ---------------------------------------------------------------- the card

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the decode block is a CUDA graph)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_whisper_decode_block_graph_is_bitwise_the_eager_block(cuda):
    model = get_arch(ARCH).make_smoke()
    params = model.init(torch.Generator("cuda").manual_seed(0))
    graph = ServeEngine(model, params, EngineConfig(**_ENGINE),
                        keep_logits=True, frontend="audio")
    eager = ServeEngine(model, params, EngineConfig(**_ENGINE),
                        cuda_graphs=False, keep_logits=True,
                        frontend="audio")
    for req in _requests(Request, None):
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
    per_replay = 2 * SMOKE.n_dec_layers * _ENGINE["decode_block"]
    assert graph.block_stats.captured_launches == {
        v: {"paged_attention": per_replay} for v in ("greedy", "sampled")}
