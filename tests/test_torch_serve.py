"""The port's ServeEngine against the JAX package's, on the same params.

Greedy requests with mixed prompt lengths, one early EOS and more
requests than slots go through both engines on granite-3-2b ``SMOKE``
(float32, JAX-made params carried across).  Discrete outputs must be
identical: token streams, finish reasons, the per-step completion order,
peak pages in use (paged backend, incl. deferral under a short pool) and
every ``EngineStats`` counter.  Times are not compared.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import granite_3_2b  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serve import (EngineConfig, NaiveLoop, Request,  # noqa: E402
                               SamplingParams, ServeEngine)

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"

# 6 requests over 4 slots: the first tick admits lengths {6, 9, 12} with
# one bucket holding two requests; the rest are admitted midstream.
_PROMPT_LENS = (6, 6, 9, 12, 6, 3)
_BUDGETS = (5, 3, 7, 2, 6, 4)
_EOS_REQ = 2            # this request stops at its third token (EOS)

_COUNTERS = ("requests_completed", "prompt_tokens", "generated_tokens",
             "decode_ticks", "prefill_batches", "admit_ticks",
             "slot_ticks_active", "slot_ticks_total")


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, granite_3_2b.SMOKE.vocab, n).tolist()
            for n in _PROMPT_LENS]


@pytest.fixture(scope="module")
def port():
    """The port's smoke model on JAX-made params, or its own init where
    JAX is absent."""
    model = DecoderLM(granite_3_2b.SMOKE)
    try:
        import jax
    except ImportError:
        return model, model.init(torch.Generator().manual_seed(0))
    from repro.configs import granite_3_2b as jg
    from repro_torch.convert import params_from_numpy
    jp = jax.device_get(jg.ARCH.make_smoke().init(jax.random.PRNGKey(0)))
    return model, params_from_numpy(jp, "cpu")


def _cfg(backend, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq", 32)
    kw.setdefault("decode_block", 4)
    if backend == "paged":
        kw.setdefault("kv_backend", "paged")
        kw.setdefault("page_size", 8)
    return kw


def _drive(engine, request_cls, eos_id):
    """Submit the workload and step to idle; returns the completions by
    id, the ids finished at each step, and the engine."""
    for i, (p, g) in enumerate(zip(_prompts(), _BUDGETS, strict=True)):
        engine.submit(request_cls(tokens=p, max_new_tokens=g, request_id=i,
                                  eos_id=eos_id if i == _EOS_REQ else None))
    order, comps = [], {}
    while engine.has_work:
        done = engine.step()
        order.append(sorted(c.request_id for c in done))
        comps.update((c.request_id, c) for c in done)
    return comps, order, engine


def _summary(comps, order, engine):
    st = engine.stats
    out = {
        "tokens": {i: c.tokens for i, c in comps.items()},
        "finish": {i: c.finish_reason for i, c in comps.items()},
        "order": order,
        "stats": {k: getattr(st, k) for k in _COUNTERS},
    }
    if engine.pool.backend == "paged":
        out["peak_pages"] = engine.pool.peak_pages_in_use
        out["pages_in_use"] = engine.pool.pages_in_use
    return out


@pytest.fixture(scope="module")
def eos_id(port):
    """The token request ``_EOS_REQ`` emits third when run greedily."""
    model, params = port
    eng = ServeEngine(model, params, EngineConfig(**_cfg("contiguous")),
                      device="cpu")
    comps, _, _ = _drive(eng, Request, None)
    return comps[_EOS_REQ].tokens[2]


def _port_run(port, eos_id, **cfg):
    model, params = port
    eng = ServeEngine(model, params, EngineConfig(**cfg), device="cpu")
    return _summary(*_drive(eng, Request, eos_id))


def _jax_run(eos_id, **cfg):
    jax = pytest.importorskip("jax")
    from repro.configs import granite_3_2b as jg
    from repro.serve import EngineConfig as JConfig
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JEngine
    model = jg.ARCH.make_smoke()
    params = model.init(jax.random.PRNGKey(0))
    return _summary(*_drive(JEngine(model, params, JConfig(**cfg)),
                            JRequest, eos_id))


# ------------------------------------------------------------- parity

@pytest.mark.parametrize("backend,batched,chunk,kv_pages", [
    ("contiguous", True, None, None),
    ("contiguous", False, None, None),
    ("paged", True, None, None),
    ("paged", False, None, None),
    ("paged", True, 8, None),          # right-padded prefill + refeed
    ("paged", True, None, 5),          # short pool: admission defers
], ids=["contiguous-batched", "contiguous-serial", "paged-batched",
        "paged-serial", "paged-chunked", "paged-deferral"])
def test_engine_matches_jax_engine(port, eos_id, backend, batched, chunk,
                                   kv_pages):
    cfg = _cfg(backend, batched_admission=batched, prefill_chunk=chunk)
    if kv_pages:
        cfg["kv_pages"] = kv_pages
    ours = _port_run(port, eos_id, **cfg)
    theirs = _jax_run(eos_id, **cfg)
    assert ours == theirs
    assert ours["finish"][_EOS_REQ] == "stop"
    assert ours["tokens"][_EOS_REQ][-1] == eos_id
    assert {len(t) for t in ours["tokens"].values()} != {1}
    if kv_pages:       # fewer pages than the workload's worst case
        assert ours["peak_pages"] <= kv_pages - 1
        assert ours["stats"]["admit_ticks"] > 2


# --------------------------------------------------------- inside the port

def test_paged_and_contiguous_give_identical_streams(port, eos_id):
    paged = _port_run(port, eos_id, **_cfg("paged"))
    cont = _port_run(port, eos_id, **_cfg("contiguous"))
    assert paged["tokens"] == cont["tokens"]
    assert paged["finish"] == cont["finish"]


def test_engine_matches_naive_loop(port):
    model, params = port
    loop = NaiveLoop(model, params, device="cpu")
    ours = _port_run(port, None, **_cfg("paged"))
    for i, (p, g) in enumerate(zip(_prompts(), _BUDGETS, strict=True)):
        want = loop.generate([p], g)[0].tolist()
        assert ours["tokens"][i] == want


def test_seeded_sampling_is_batch_independent(port):
    """A sampling request's stream does not depend on what shares its
    batch: alone or among greedy requests, the same tokens."""
    model, params = port
    sp = SamplingParams(temperature=3.0, top_k=50, seed=42)
    prompt = _prompts()[0]

    def run(n_others, backend):
        eng = ServeEngine(model, params, EngineConfig(**_cfg(backend)),
                          device="cpu")
        reqs = [Request(tokens=prompt, max_new_tokens=9, sampling=sp)] + [
            Request(tokens=p, max_new_tokens=6)
            for p in _prompts()[1:1 + n_others]]
        return eng.generate(reqs)[0].tokens

    alone = run(0, "contiguous")
    assert run(3, "contiguous") == alone
    assert run(5, "paged") == alone
    # the draws are real: another seed gives another stream
    other = SamplingParams(temperature=3.0, top_k=50, seed=7)
    eng = ServeEngine(model, params, EngineConfig(**_cfg("contiguous")),
                      device="cpu")
    again = eng.generate([Request(tokens=prompt, max_new_tokens=9,
                                  sampling=other)])[0].tokens
    assert again != alone


def test_sampler_greedy_ties_and_top_k():
    from repro_torch.serve.sampling import make_token_sampler
    sample = make_token_sampler(5)
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0, -1.0]] * 3)
    temp = torch.tensor([0.0, 1.0, 1.0])
    top_k = torch.tensor([0, 2, 1], dtype=torch.int32)
    u = torch.tensor([0.5, 0.99, 0.99])
    tok = sample(logits, temp, top_k, u).tolist()
    assert tok[0] == 1                 # argmax: first maximal index
    assert tok[1] == 2                 # top-2 keeps the tied pair
    assert tok[2] == 2                 # top-1 threshold still keeps ties


def test_engine_rejects_what_it_cannot_serve(port):
    model, params = port
    eng = ServeEngine(model, params, EngineConfig(**_cfg("paged")),
                      device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(Request(tokens=list(range(30)), max_new_tokens=4))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.submit(Request(tokens=[1, 2], extra=(np.zeros((2, 64)),)))


# ------------------------------------------------------------- device

def test_resolve_device_raises_without_a_gpu_and_cpu_works(port):
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    model, params = port
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, params, EngineConfig(**_cfg("paged")))
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_never_imports_jax_or_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.serve, repro_torch.launch.serve\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.paged_attention\n"
        "bad = sorted(m for m in sys.modules if m.startswith('jax') or "
        "m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
