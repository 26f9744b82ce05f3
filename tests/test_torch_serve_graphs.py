"""The serve engine's decode block as CUDA graphs, on the card.

Every test here needs a CUDA device (``-m gpu``; skipped without one)
and runs the smoke configs in float32 with params from a seeded
generator.  For dense paged, dense contiguous and Mamba-2 contiguous,
greedy and sampled:

* a graphed engine against the same body run eagerly
  (``cuda_graphs=False``) in lockstep: each block's logits **bitwise**
  equal (the same kernels on the same inputs), then streams, finish
  reasons and every ``EngineStats`` counter equal;
* what the graphs hold: two variants captured, the paged kernel's
  launches per replay (layers x ``decode_block``), replays x those;
* the paged kernel's split-K scratch belongs to the engine: engine A,
  then a larger engine B and eager launches of a larger shape, then A
  again, gives A's streams unchanged;
* ``reset(params=...)`` then a replay equals a fresh engine on those
  params, every parameter at its old address;
* a capture that fails (a host read inside the body) raises from the
  constructor instead of running eagerly.

Run on the card with ``python -m pytest --noconftest -q -m gpu
tests/test_torch_*.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import granite_3_2b, mamba2_780m  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.models.mamba2 import Mamba2LM  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serve import (EngineConfig, Request,  # noqa: E402
                               SamplingParams, ServeEngine)
from repro_torch.tree import tree_leaves  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
_LENS = (6, 6, 9, 12, 6, 3, 17)
_BUDGETS = (5, 3, 7, 2, 6, 4, 9)
_COUNTERS = ("requests_completed", "prompt_tokens", "generated_tokens",
             "decode_ticks", "prefill_batches", "admit_ticks",
             "slot_ticks_active", "slot_ticks_total")
_PATHS = [("dense", "paged"), ("dense", "contiguous"),
          ("mamba2", "contiguous")]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs run on the card)")
    return torch.device("cuda")


def _model(family):
    return DecoderLM(granite_3_2b.SMOKE) if family == "dense" \
        else Mamba2LM(mamba2_780m.SMOKE)


def _params(model, seed=0):
    return model.init(torch.Generator("cuda").manual_seed(seed))


def _cfg(backend, **kw):
    kw = {"max_batch": 4, "max_seq": 32, "decode_block": 4, **kw}
    if backend == "paged":
        kw.update(kv_backend="paged", page_size=8)
    return EngineConfig(**kw)


def _requests(vocab, sampled, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(tokens=rng.integers(0, vocab, n).tolist(),
                    max_new_tokens=g, request_id=i,
                    sampling=SamplingParams(temperature=1.5, top_k=20,
                                            seed=i) if sampled and i % 2
                    else SamplingParams())
            for i, (n, g) in enumerate(zip(_LENS, _BUDGETS, strict=True))]


def _summary(engine, comps):
    return ({c.request_id: c.tokens for c in comps},
            {c.request_id: c.finish_reason for c in comps},
            {k: getattr(engine.stats, k) for k in _COUNTERS})


@pytest.mark.gpu
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("family,backend", _PATHS,
                         ids=["dense-paged", "dense-contiguous",
                              "mamba2-contiguous"])
def test_graph_replay_is_bitwise_the_eager_body(cuda, family, backend,
                                                sampled):
    model = _model(family)
    params = _params(model)
    graph = ServeEngine(model, params, _cfg(backend), keep_logits=True)
    eager = ServeEngine(model, params, _cfg(backend), cuda_graphs=False,
                        keep_logits=True)
    done = {"graph": [], "eager": []}
    for eng in (graph, eager):
        for r in _requests(model.cfg.vocab, sampled):
            eng.submit(r)
    blocks = 0
    while graph.has_work or eager.has_work:
        done["graph"] += graph.step()
        done["eager"] += eager.step()
        torch.cuda.synchronize()
        assert torch.equal(graph.last_logits, eager.last_logits), blocks
        blocks += 1
    assert _summary(graph, done["graph"]) == _summary(eager, done["eager"])
    bs = graph.block_stats
    assert bs.graphs == 2 and eager.block_stats.graphs == 0
    assert bs.replays == blocks == graph.stats.decode_ticks
    # a block samples while some running request samples
    assert (bs.blocks["sampled"] > 0) == sampled
    assert bs.blocks == eager.block_stats.blocks
    assert eager.block_stats.captured_launches == {}
    per_replay = model.cfg.n_layers * 4
    if backend == "paged":
        assert bs.captured_launches == {
            v: {"paged_attention": per_replay}
            for v in ("greedy", "sampled")}
        assert bs.kernel_launches() == {"paged_attention":
                                        per_replay * blocks}
    else:
        assert bs.kernel_launches() == {}
    assert graph.compile_stats()["decode_block"] == 2


@pytest.mark.gpu
def test_paged_scratch_outlives_a_larger_engine(cuda):
    model = _model("dense")
    params = _params(model)
    reqs = lambda: _requests(model.cfg.vocab, True)        # noqa: E731
    a = ServeEngine(model, params, _cfg("paged"))
    first = _summary(a, a.generate(reqs()))
    b = ServeEngine(model, params, _cfg("paged", max_batch=8, max_seq=64))
    b.generate(reqs())
    # eager launches of a larger shape grow the wrapper's shared scratch
    q = torch.randn(16, 32, 64, device="cuda")
    pages = torch.randn(1 + 16 * 64, 16, 8, 64, device="cuda")
    bt = torch.arange(1, 1 + 16 * 64, dtype=torch.int32,
                      device="cuda").view(16, 64)
    kv_len = torch.full((16,), 1000, dtype=torch.int32, device="cuda")
    paged_attention(q, pages, pages, bt, kv_len)
    torch.cuda.synchronize()
    del b
    a.reset()
    assert _summary(a, a.generate(reqs())) == first


@pytest.mark.gpu
@pytest.mark.parametrize("family,backend", _PATHS,
                         ids=["dense-paged", "dense-contiguous",
                              "mamba2-contiguous"])
def test_reset_params_then_replay_equals_a_fresh_engine(cuda, family,
                                                        backend):
    model = _model(family)
    eng = ServeEngine(model, _params(model), _cfg(backend))
    ptrs = [t.data_ptr() for t in tree_leaves(eng.params)]
    eng.generate(_requests(model.cfg.vocab, True))
    new = _params(model, seed=1)
    eng.reset(params=new)
    assert [t.data_ptr() for t in tree_leaves(eng.params)] == ptrs
    got = _summary(eng, eng.generate(_requests(model.cfg.vocab, True)))
    fresh = ServeEngine(model, new, _cfg(backend))
    assert got == _summary(fresh, fresh.generate(
        _requests(model.cfg.vocab, True)))
    assert eng.compile_stats()["decode_block"] == 2


_FAILING_CAPTURE = """
import torch
from repro_torch.configs import granite_3_2b
from repro_torch.models.transformer import DecoderLM
from repro_torch.serve import EngineConfig, ServeEngine

model = DecoderLM(granite_3_2b.SMOKE)
params = model.init(torch.Generator("cuda").manual_seed(0))
step = model.decode_step_paged

def host_read(*args, **kw):
    logits, pages = step(*args, **kw)
    logits.sum().item()            # a host read: no capture allows it
    return logits, pages

model.decode_step_paged = host_read
try:
    ServeEngine(model, params, EngineConfig(
        max_batch=2, max_seq=16, kv_backend="paged", page_size=8))
except RuntimeError as e:
    assert "capturing the greedy decode block" in str(e), e
    print("raised")
"""


@pytest.mark.gpu
def test_a_failed_capture_raises(cuda):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _FAILING_CAPTURE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "raised"
