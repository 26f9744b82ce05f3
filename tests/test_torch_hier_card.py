"""The async two-tier runtime on the card (``-m gpu``; skipped without a
CUDA device).

granite-3-2b SMOKE (float32), 2 workers in one datacenter, H = 3, 2
periods, from one template and the same host batches: the card's runner
(through the fused AdamW kernel) against the CPU's (its plain version)
gives the same op log and trace, losses within ``rtol=1e-4`` (float32
matmuls summed in another order) and 11 x H fused AdamW launches per
period; a card run restored from a mid-run checkpoint ends **bitwise**
where the uninterrupted card run ends.  The CPU tests against the JAX
package are in ``tests/test_torch_hier.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api.registry import get_strategy  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import granite_3_2b  # noqa: E402
from repro_torch.core import HardwareSpec, analytic_profile  # noqa: E402
from repro_torch.data import MarkovCorpus  # noqa: E402
from repro_torch.hier import (AsyncHierRunner,  # noqa: E402
                              AsyncRunnerConfig, PeriodOp)
from repro_torch.kernels.fused_adam_sync import fused_adamw  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.sim import LinkSpec, Scenario  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

H, PERIODS = 3, 2

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fused AdamW kernel)")
    return torch.device("cuda")


def _runner(device, params, **kw):
    model = DecoderLM(granite_3_2b.SMOKE)
    sc = Scenario(name="card", description="", n_workers=2,
                  n_datacenters=1,
                  intra=LinkSpec(bandwidth=1e12, latency=1e-7, jitter=0.0),
                  inter=None, drift={}, events=(), periods=PERIODS, seed=0)
    profile = analytic_profile(model.layer_costs(2, 32),
                               HardwareSpec(bandwidth=1e12, latency=1e-7,
                                            n_workers=2))
    data = MarkovCorpus(vocab=model.cfg.vocab, seq_len=32,
                        batch_per_worker=2, n_workers=2, seed=0)
    return AsyncHierRunner(
        model, make_optimizer("adam", lr=3e-3, warmup_steps=2),
        get_strategy("hier-async"), data, profile=profile, scenario=sc,
        H=H, seed=0, params=tree_map(lambda x: x.to(device), params),
        device=device, **kw)


def _leaves(runner):
    out = tree_leaves(runner.server.state())
    for w in sorted(runner.states):
        st = runner.states[w]._asdict()
        out += tree_leaves({k: v for k, v in st.items() if v is not None})
    return out


def test_async_runner_on_the_card(cuda, tmp_path):
    params = DecoderLM(granite_3_2b.SMOKE).init(
        torch.Generator(cuda).manual_seed(0))
    card, cpu = _runner(cuda, params), _runner("cpu", params)
    ops = card._schedule(PERIODS)[0]
    assert [repr(o) for o in ops] == [repr(o) for o in
                                      cpu._schedule(PERIODS)[0]]
    fused_adamw.launches = 0
    trace = card.run(PERIODS)
    torch.cuda.synchronize()
    periods = sum(isinstance(o, PeriodOp) for o in ops)
    assert fused_adamw.launches == 11 * H * periods
    assert trace.fingerprint() == cpu.run(PERIODS).fingerprint()
    np.testing.assert_allclose([h["loss"] for h in card.history],
                               [h["loss"] for h in cpu.history], rtol=1e-4)
    ck = _runner(cuda, params, ckpt=CheckpointManager(str(tmp_path)),
                 run_cfg=AsyncRunnerConfig(ckpt_every_merges=2))
    ck.run(PERIODS)
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir()
                   if p.name.startswith("step_"))
    res = _runner(cuda, params, ckpt=CheckpointManager(str(tmp_path)))
    res.restore(step=steps[0])
    assert res.run(PERIODS).fingerprint() == trace.fingerprint()
    for x, y in zip(_leaves(res), _leaves(card), strict=True):
        assert torch.equal(x, y)
