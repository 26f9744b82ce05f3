"""Mamba-2 under the runner's ``compiled`` period executor.

mamba2-780m's ``SMOKE`` (3 layers, d_model 48, chunk 8, float32) trained
by ``Session.fit`` on 2 workers, H = 2, 2 x 32 tokens a worker.  The
training forward is the SSD einsum path under remat (the chunk kernel
has no backward), with the conv window and the chunk loop inside the
period body.

* On the CPU (the period body runs without a graph): ``compiled`` ends
  **bitwise** where ``pipeline`` ends, losses equal, for ``dreamddp``
  and ``dreamddp-int8``; a run with a checkpoint every period and a
  failure inside the second period, restored in place, ends bitwise
  where the uninterrupted run ends.
* On the card (``-m gpu``; skipped without CUDA): the same, with the
  first period eager, one capture, then a replay a period, fused AdamW
  one launch a leaf a step with replays reckoned in, and no SSD chunk
  launch.
"""

import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import JobConfig, Session  # noqa: E402
from repro_torch.kernels.fused_adam_sync import fused_adamw  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunk_grouped  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

H, STEPS = 2, 6            # an eager period, a capture, two replays


def _session(algo, exec_, device, **kw):
    return Session(JobConfig(arch="mamba2-780m", smoke=True, algo=algo,
                             workers=2, period=H, seq=32,
                             batch_per_worker=2, period_exec=exec_, **kw),
                   device=device)


def _leaves(state):
    return [x for x in tree_leaves(state._asdict()) if x is not None]


def _assert_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert torch.equal(x, y)


def _compiled_against_pipeline(algo, device):
    pipe = _session(algo, "pipeline", device).fit(STEPS)
    comp = _session(algo, "compiled", device).fit(STEPS)
    _assert_equal(pipe.state, comp.state)
    assert [h["loss"] for h in pipe.history] == \
        [h["loss"] for h in comp.history]
    assert all(math.isfinite(h["loss"]) for h in comp.history)
    return comp


def _restart(device, tmp_path):
    ok = _session("dreamddp", "compiled", device).fit(STEPS)
    sess = _session("dreamddp", "compiled", device,
                    ckpt_dir=str(tmp_path), ckpt_every=H)
    r = sess.runner
    state = r.run(sess.state, STEPS, fused=True, inject_failure_at=H + 1)
    assert r.retries == 1
    _assert_equal(ok.state, state)
    return r


@pytest.mark.parametrize("algo", ["dreamddp", "dreamddp-int8"])
def test_compiled_is_bitwise_the_pipeline_cpu(algo):
    _compiled_against_pipeline(algo, "cpu")


def test_a_restart_matches_cpu(tmp_path):
    _restart("cpu", tmp_path)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs run on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["dreamddp", "dreamddp-int8"])
def test_compiled_captures_mamba2(cuda, algo):
    ssd_chunk_grouped.launches = 0
    fused_adamw.launches = 0
    comp = _compiled_against_pipeline(algo, cuda)
    stats = comp.runner.graph_stats
    n_leaves = len(tree_leaves(comp.state.params))
    assert stats.graphs == 1 and stats.replays[()] == STEPS // H - 1
    assert stats.captured_launches[()]["fused_adamw"] == n_leaves * H
    # the pipeline run's launches, the compiled run's eager ones and
    # what its replays ran
    eager = fused_adamw.launches - n_leaves * STEPS \
        - stats.captured_launches[()]["fused_adamw"]
    assert eager + stats.kernel_launches()["fused_adamw"] == \
        n_leaves * STEPS
    assert ssd_chunk_grouped.launches == 0


@pytest.mark.gpu
def test_a_restart_keeps_the_graph(cuda, tmp_path):
    r = _restart(cuda, tmp_path)
    assert r.graph_stats.graphs == 1
