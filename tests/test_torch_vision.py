"""The port's vision prefix (llava-next-34b) against the JAX package's
``DecoderLM`` with ``embeds``, on the CPU, at llava's ``SMOKE`` (3
layers, d_model 64, 8 heads over 2 KV heads of width 8, d_ff 160, vocab
512, float32).

Parameters are the port's, carried to JAX as numpy; patch embeddings and
tokens are made with numpy from a seed.

* **The model** — logits of ``apply`` with ``embeds`` (and with
  ``embeds`` alone), the text-tail ``loss`` and its gradients, and
  ``prefill`` with ``embeds`` (logits and every cache leaf) then decode
  steps at positions after the prefix, contiguous and paged: ``TOL``
  (float32 sums in another order over 3 layers).
* **Serving** — greedy streams, finish reasons, completion order, peak
  pages and every ``EngineStats`` counter **equal** to the JAX
  ``ServeEngine``'s on contiguous and paged KV, batched and serial
  admission, with mid-stream admission, a request stopping at an EOS,
  and chunked prefill (the refeed at ``prefix + s - 1``); a vision
  request whose prefix and padded prompt fill the lane exactly, as
  ``tests/test_batched_admission.py`` holds the reference; the CLI,
  ``Session.serve`` and ``InferenceSession``.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import llava_next_34b as jax_llava  # noqa: E402
from repro.models.transformer import DecoderLM as JDecoderLM  # noqa: E402
from repro_torch.api import InferenceSession, JobConfig, Session  # noqa: E402
from repro_torch.configs import get_arch, llava_next_34b  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.runtime.step import prefix_len  # noqa: E402
from repro_torch.serve import (EngineConfig, NaiveLoop, Request,  # noqa: E402
                               ServeEngine)
from repro_torch.tree import tree_map  # noqa: E402

torch.set_num_threads(1)

ARCH = "llava-next-34b"
SMOKE = llava_next_34b.SMOKE
TOL = 1e-4          # float32 sums in another order over 3 layers
N_PATCH = 8         # the reference tests' vision prefix


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


def _patches(seed, b, n=N_PATCH):
    return np.random.default_rng(seed).standard_normal(
        (b, n, SMOKE.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def model():
    tm = DecoderLM(SMOKE)
    tp = tm.init(torch.Generator().manual_seed(0))
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))
    return JDecoderLM(jax_llava.SMOKE), jp, tm, tp


def test_arch_is_the_reference_vision_frontend():
    arch, jarch = get_arch(ARCH), jget_arch(ARCH)
    assert arch.frontend == jarch.frontend == "vision"
    assert arch.family == jarch.family == "vlm"
    assert isinstance(arch.make_model(), DecoderLM)
    assert arch.make_model().cfg.n_heads // arch.make_model().cfg \
        .n_kv_heads == 7                        # GQA group 7


@pytest.mark.parametrize("frontend,shape,want", [
    ("vision", (5, 16), 5), ("vision", (3, 5, 16), 5),
    ("audio", (24, 16), 0), (None, None, 0)])
def test_prefix_len(frontend, shape, want):
    """Patches (one request's ``[n, d]`` or a batch's ``[B, n, d]``)
    take cache positions before the prompt; audio frames do not."""
    extra = () if shape is None else (np.zeros(shape, np.float32),)
    assert prefix_len(frontend, extra) == want


def test_reference_params_round_trip_exactly():
    """llava's bfloat16 tree of the reference's keys and shapes (an
    untied head) comes into the port and back bitwise."""
    shapes = jax.eval_shape(JDecoderLM(dataclasses.replace(
        jax_llava.SMOKE, param_dtype="bfloat16")).init,
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        a.dtype), shapes)
    ours = params_from_numpy(tree, "cpu")
    assert "out" in ours["head"]
    assert all(v.dtype == torch.bfloat16 for v in _flat(ours).values())
    back, want = _flat(params_to_numpy(ours)), _flat(tree)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], np.asarray(want[k],
                                                          np.float32))


@pytest.mark.parametrize("with_tokens", [True, False])
def test_apply_with_embeds_matches(model, with_tokens):
    jm, jp, tm, tp = model
    tok = _tokens(1, (2, 13)) if with_tokens else None
    emb = _patches(1, 2)
    with torch.no_grad():
        ours = tm.apply(tp, None if tok is None else torch.from_numpy(tok),
                        embeds=torch.from_numpy(emb))
    theirs = jax.jit(lambda p, t, e: jm.apply(p, t, embeds=e))(
        jp, None if tok is None else jnp.asarray(tok), jnp.asarray(emb))
    assert ours.shape == theirs.shape
    _close(ours, theirs)


def test_text_tail_loss_and_grads_match(model):
    jm, jp, _, tp = model
    tm = DecoderLM(SMOKE)
    tok = _tokens(2, (2, 11))
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1),
             "embeds": _patches(2, 2)}
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    loss = tm.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    _close(loss, jloss)
    ours, theirs = _flat(tp), _flat(jax.device_get(jgrads))
    for k in ours:
        _close(ours[k].grad, theirs[k])


@pytest.mark.parametrize("backend", ["contiguous", "paged"])
def test_prefill_with_embeds_then_decode_match(model, backend):
    """Prefill of a prefix of 8 patches and 9 tokens (logits and every
    cache leaf), then 4 greedy decode steps at positions 17.., on the
    contiguous cache and on pages scattered from it."""
    from repro_torch.serve.cache import prefill_scatter
    jm, jp, tm, tp = model
    b, depth, ps = 2, 24, 8
    tok, emb = _tokens(3, (b, 9)), _patches(3, b)
    with torch.no_grad():
        lg, cache = tm.prefill(tp, torch.from_numpy(tok),
                               tm.init_cache(b, depth, device="cpu"),
                               embeds=torch.from_numpy(emb))
    jlg, jcache = jax.jit(lambda p, t, c, e: jm.prefill(p, t, c, embeds=e))(
        jp, jnp.asarray(tok), jm.init_cache(b, depth), jnp.asarray(emb))
    _close(lg, jlg)
    ours, theirs = _flat(cache), _flat(jax.device_get(jcache))
    assert ours.keys() == theirs.keys()
    for k in ours:
        _close(ours[k], theirs[k])
    if backend == "paged":
        nb = depth // ps
        pages = tm.init_paged_cache(1 + b * nb, ps, device="cpu")
        bt = torch.arange(1, 1 + b * nb, dtype=torch.int32).reshape(b, nb)
        prefill_scatter(pages, cache, bt, ps)
    jdecode = jax.jit(jm.decode_step)
    nxt = lg.argmax(-1).to(torch.int32)
    for i in range(4):
        pos = torch.full((b,), N_PATCH + 9 + i, dtype=torch.int32)
        with torch.no_grad():
            if backend == "paged":
                lg, pages = tm.decode_step_paged(
                    tp, pages, nxt, pos, bt, torch.ones(b, dtype=torch.bool))
            else:
                lg, cache = tm.decode_step(tp, cache, nxt, pos)
        jlg, jcache = jdecode(jp, jcache, jnp.asarray(nxt.numpy()),
                              jnp.asarray(pos.numpy()))
        _close(lg, jlg)
        nxt = lg.argmax(-1).to(torch.int32)


# ---------------------------------------------------------------- serving

_PROMPT_LENS = (8, 5, 8, 11, 5, 13)
_BUDGETS = (6, 4, 9, 3, 7, 5)
_EOS_REQ = 2
_COUNTERS = ("requests_completed", "prompt_tokens", "generated_tokens",
             "decode_ticks", "prefill_batches", "admit_ticks",
             "slot_ticks_active", "slot_ticks_total")
# (backend, batched admission, prefill chunk)
_CASES = [("contiguous", True, None), ("contiguous", False, None),
          ("paged", True, None), ("paged", False, None),
          ("paged", True, 8)]


def _engine_cfg(backend, batched, chunk):
    return dict(max_batch=2, max_seq=32, decode_block=4, kv_backend=backend,
                page_size=8, batched_admission=batched, prefill_chunk=chunk)


def _requests(request_cls, eos_id):
    rng = np.random.default_rng(0)
    return [request_cls(
        tokens=rng.integers(0, SMOKE.vocab, n).tolist(), max_new_tokens=g,
        request_id=i, eos_id=eos_id if i == _EOS_REQ else None,
        extra=(rng.standard_normal((N_PATCH, SMOKE.d_model))
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
    pool = engine.pool
    return {"tokens": {i: c.tokens for i, c in comps.items()},
            "finish": {i: c.finish_reason for i, c in comps.items()},
            "order": order,
            "stats": {k: getattr(st, k) for k in _COUNTERS},
            "peak_pages": getattr(pool, "peak_pages_in_use", None)}


@pytest.fixture(scope="module")
def eos_id(model):
    _, _, tm, tp = model
    first = _drive(ServeEngine(tm, tp, EngineConfig(**_engine_cfg(
        "contiguous", True, None)), device="cpu", frontend="vision"),
        Request, None)
    return first["tokens"][_EOS_REQ][2]       # stops at its 3rd token


@pytest.mark.parametrize("backend,batched,chunk", _CASES)
def test_engine_matches_jax_engine(model, eos_id, backend, batched, chunk):
    """Six requests over two slots, each with its own 8 patches; one
    stops at an EOS."""
    from repro.serve import EngineConfig as JConfig
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JEngine
    jm, jp, tm, tp = model
    cfg = _engine_cfg(backend, batched, chunk)
    ours = _drive(ServeEngine(tm, tp, EngineConfig(**cfg), device="cpu",
                              frontend="vision"), Request, eos_id)
    theirs = _drive(JEngine(jm, jp, JConfig(**cfg), frontend="vision"),
                    JRequest, eos_id)
    assert ours == theirs
    assert ours["finish"][_EOS_REQ] == "stop"


def test_paged_vision_chunked_admission_at_capacity(model):
    """The prefix counts toward both bounds, once: 8 + max(5 + 3, 16) =
    24 fills the lane, and the commitment 8 + 5 + 3 = 16 takes two
    8-token pages of a 3-page pool; the tokens are the naive loop's."""
    _, _, tm, tp = model
    extra = (_patches(5, 1)[0],)
    cfg = EngineConfig(max_batch=1, max_seq=24, decode_block=2,
                       prefill_chunk=16, kv_backend="paged", page_size=8,
                       kv_pages=3)
    eng = ServeEngine(tm, tp, cfg, device="cpu", frontend="vision")
    comp = eng.generate([Request(tokens=[3, 1, 4, 1, 5], max_new_tokens=3,
                                 extra=extra)])[0]
    want = NaiveLoop(tm, tp, device="cpu", frontend="vision").generate(
        [[3, 1, 4, 1, 5]], 3, extra[0][None])[0].tolist()
    assert comp.tokens == want
    assert eng.pool.peak_pages_in_use == 2
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(Request(tokens=list(range(12)), max_new_tokens=5,
                           extra=extra))


def test_cli_session_and_inference_session(model, capsys):
    from repro_torch.launch import serve as cli
    for backend in ("contiguous", "paged"):
        assert cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--kv-backend", backend, "--batch", "2",
                         "--prompt-len", "6", "--gen", "4"]) == 0
        assert "requests=2" in capsys.readouterr().out
    _, _, tm, tp = model
    sess = Session(JobConfig(arch=ARCH, smoke=True), params=tp,
                   device="cpu")
    cfg = EngineConfig(max_batch=2, max_seq=32, kv_backend="paged",
                       page_size=8)
    engine = sess.serve(config=cfg)
    assert engine.frontend == "vision"
    tok, emb = _tokens(8, (2, 6)), _patches(8, 2)
    got = engine.generate(tok, 5, emb)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        legacy = InferenceSession(tm, tp, frontend="vision", device="cpu")
        assert torch.equal(legacy.generate(tok, 5, emb), got)
        assert legacy.engine.config.max_seq >= N_PATCH + 6 + 5
    loop = NaiveLoop(tm, tp, device="cpu", frontend="vision")
    assert torch.equal(loop.generate(tok, 5, emb), got)
    # an engine without the frontend refuses the patches
    plain = ServeEngine(tm, tp, EngineConfig(max_batch=1, max_seq=32),
                        device="cpu")
    with pytest.raises(ValueError, match="without a frontend"):
        plain.submit(Request(tokens=[1, 2], extra=(emb[0],)))
