"""The runner's ``compiled`` periods as CUDA graphs, on the card.

Every test here needs a CUDA device (``-m gpu``; skipped without one) and
trains granite-3-2b SMOKE (float32) on 2 workers with H = 3:

* ``compiled`` against ``pipeline`` on the same initial parameters and
  batches: states and losses **bitwise** equal (the same kernels on the
  same inputs), for ``dreamddp`` and ``dreamddp-int8``; the first period
  eager, one capture, then one replay per period; the fused AdamW
  launches, the wrapper's eager count plus replays x what the graph
  holds, exactly 11 a step;
* a failure after the capture: the checkpoint restored in place, no new
  capture, the state bitwise that of an uninterrupted run;
* an elastic restore drops the graphs and the next full period captures
  again, on the resharded state;
* a capture that fails (a host read inside the period) raises instead of
  running the period some other way.

The CPU tests of the same code are in ``tests/test_torch_train.py``.
Run on the card with ``python -m pytest --noconftest -q -m gpu
tests/test_torch_*.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import JobConfig, Session  # noqa: E402
from repro_torch.kernels.fused_adam_sync import fused_adamw  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
H = 3


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs run on the card)")
    return torch.device("cuda")


def _session(algo, exec_, **kw):
    return Session(JobConfig(algo=algo, workers=2, period=H, seq=32,
                             batch_per_worker=2, period_exec=exec_, **kw),
                   device="cuda")


def _leaves(state):
    return [x for x in tree_leaves(state._asdict()) if x is not None]


def _assert_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["dreamddp", "dreamddp-int8"])
def test_compiled_is_bitwise_the_pipeline(cuda, algo):
    n = 3 * H + 1                              # eager, 2 replays, a tail
    pipe = _session(algo, "pipeline").fit(n)
    fused_adamw.launches = 0
    comp = _session(algo, "compiled").fit(n)
    _assert_equal(pipe.state, comp.state)
    assert [h["loss"] for h in pipe.history] == \
        [h["loss"] for h in comp.history]
    stats = comp.runner.graph_stats
    assert stats.graphs == 1 and stats.replays[()] == 2
    assert stats.captured_launches[()]["fused_adamw"] == 11 * H
    assert (stats.captured_by_shape[()] != {}) == (algo == "dreamddp-int8")
    eager = fused_adamw.launches - stats.captured_launches[()]["fused_adamw"]
    assert eager + stats.kernel_launches()["fused_adamw"] == 11 * n
    assert stats.pool_bytes > 0 and stats.capture_s > 0


@pytest.mark.gpu
def test_a_restart_keeps_the_graph_and_matches(cuda, tmp_path):
    n = 4 * H
    ok = _session("dreamddp-int8", "compiled").fit(n)
    sess = _session("dreamddp-int8", "compiled",
                    ckpt_dir=str(tmp_path), ckpt_every=H)
    r = sess.runner
    state = r.run(sess.state, n, fused=True, inject_failure_at=2 * H + 1)
    assert r.retries == 1 and r.graph_stats.graphs == 1
    assert r.graph_stats.replays[()] == 3         # periods 2, 3 and 4
    _assert_equal(ok.state, state)


@pytest.mark.gpu
def test_elastic_restore_drops_and_recaptures(cuda, tmp_path):
    sess = _session("dreamddp", "compiled", ckpt_dir=str(tmp_path),
                    ckpt_every=H).fit(2 * H)
    r = sess.runner
    assert r.graph_stats.graphs == 1
    new = Session(JobConfig(algo="dreamddp", workers=3, period=H, seq=32,
                            batch_per_worker=2), device="cuda")
    step, state = r.restore_elastic(new.state, 3, new.plan)
    assert step == 2 * H and not r._graphs
    r.data = new.runner.data
    state = r.run(state, 2 * H, start_step=step)
    assert r.graph_stats.graphs == 2 and r.graph_stats.replays[()] == 2
    assert all(x.shape[0] == 3 for x in tree_leaves(state.params))
    assert all(torch.isfinite(torch.tensor(h["loss"]))
               for h in r.history)


_FAILING_CAPTURE = """
import torch
from repro_torch.api import JobConfig, Session

sess = Session(JobConfig(workers=2, period=2, seq=16, batch_per_worker=2,
                         period_exec="compiled"), device="cuda")
loss = sess.model.loss

def host_read(*args, **kw):
    out = loss(*args, **kw)
    out.item()                     # a host read: no capture allows it
    return out

sess.model.loss = host_read
sess.fit(2)                        # the eager period reads fine
try:
    sess.fit(2)
except RuntimeError as e:
    assert "capturing the period" in str(e), e
    assert sess.runner.graph_stats.replays[()] == 0
    print("raised")
"""


@pytest.mark.gpu
def test_a_failed_capture_raises(cuda):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _FAILING_CAPTURE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "raised"
