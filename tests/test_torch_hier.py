"""The port's async two-tier runtime (``repro_torch.hier``) against the JAX
package's, on the CPU.

* **Servers** — ``GlobalServer`` halos and delayed-Nesterov merges (unit
  subsets, staleness past the clamp, a flush every ``dn_delay`` = 3
  merges) and ``LocalServer.take`` / ``merged_delta`` on the same numpy
  deltas as the JAX servers: params, momentum, buffer and averaged
  deltas within ``rtol=atol=1e-6`` (XLA:CPU fuses ``w + lr * u`` into
  one FMA, torch rounds twice); versions, staleness histograms, units
  and bases equal.  The port merges in place, so a pull's base must be a
  copy: a merge that lands between a worker's pull and its delta leaves
  the base, and the delta, as they were.
* **Runner** — ``AsyncHierRunner`` on the 4-layer d48 ``LMConfig`` of
  ``tests/test_hier_runner.py`` (float32, adam), 3 workers in 2 DCs,
  two pushes per merge, a ``WorkerLeave`` and a ``WorkerJoin``, from the
  JAX runner's template parameters and on its batches (one module-scoped
  JAX run): op log equal op for op, trace fingerprint equal, history
  rows equal with losses within ``rtol=1e-5``, server params within
  ``rtol=atol=1e-5`` for all but 0.1% of each leaf and all within
  ``1e-4``: XLA and torch sum float32 matmuls in another order, and Adam
  turns that noise on a near-zero gradient into a step of up to ``lr``
  (``tests/test_torch_train.py`` allows 1e-3 for the same reason; here
  1 of 89,520 values lands beyond, at 1.9e-5).
* **Port-only behaviour** — a mid-run checkpoint restored into a fresh
  runner replays bitwise (trace, server and worker states); elastic
  join and leave; a second ``run`` with another total is refused; a
  non-mean sync policy is refused; async ``Session.fit`` is the runner
  on the static scenario (bitwise), broadcasts the global model into
  ``state``, serves it, refuses ``replan`` and partial periods, and
  ``Session.restore`` resumes; the train CLI's ``--async``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.api.registry import get_strategy as j_get_strategy  # noqa: E402
from repro.core import HardwareSpec as JHardwareSpec  # noqa: E402
from repro.core import analytic_profile as j_analytic  # noqa: E402
from repro.data import MarkovCorpus as JMarkovCorpus  # noqa: E402
from repro.hier import AsyncConfig as JAsyncConfig  # noqa: E402
from repro.hier import AsyncHierRunner as JAsyncHierRunner  # noqa: E402
from repro.hier import AsyncRunnerConfig as JRunCfg  # noqa: E402
from repro.hier import GlobalServer as JGlobalServer  # noqa: E402
from repro.hier import LocalServer as JLocalServer  # noqa: E402
from repro.hier import MergeConfig as JMergeConfig  # noqa: E402
from repro.models.transformer import DecoderLM as JDecoderLM  # noqa: E402
from repro.models.transformer import LMConfig as JLMConfig  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro.sim import Scenario as JScenario  # noqa: E402
from repro.sim import LinkSpec as JLinkSpec  # noqa: E402
from repro.sim import WorkerJoin as JWorkerJoin  # noqa: E402
from repro.sim import WorkerLeave as JWorkerLeave  # noqa: E402
from repro_torch.api import JobConfig, Session  # noqa: E402
from repro_torch.api.registry import get_strategy  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import HardwareSpec, analytic_profile  # noqa: E402
from repro_torch.hier import (AsyncConfig, AsyncHierRunner,  # noqa: E402
                              AsyncRunnerConfig, GlobalServer, JoinOp,
                              LeaveOp, LocalServer, MergeConfig, MergeOp,
                              PeriodOp, PullOp)
from repro_torch.models.transformer import DecoderLM, LMConfig  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.runtime import StepConfig  # noqa: E402
from repro_torch.sim import LinkSpec, Scenario, WorkerJoin  # noqa: E402
from repro_torch.sim import WorkerLeave  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(1)

_TINY = dict(name="t", n_layers=4, d_model=48, n_heads=4, n_kv_heads=2,
             d_ff=96, vocab=64, param_dtype="float32", remat=False)
SEQ, H, PERIODS, WORKERS = 32, 4, 4, 3


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(mine, ref, rtol, atol):
    fa, fb = _flat(mine), _flat(ref)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_allclose(_np(fa[k]), _np(fb[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


def _leaves(tree):
    if hasattr(tree, "_asdict"):                  # a TrainState
        tree = {k: v for k, v in tree._asdict().items() if v is not None}
    return tree_leaves(tree)


def _equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# servers
# ---------------------------------------------------------------------------

# (units, base version) of each merge: unit subsets of the tiny model's
# 6 units (embed, 4 blocks, head), staleness up to 10 (past the clamp of
# 8), every unit at once last
_MERGES = [((0, 1, 2), 0), ((3, 4), 0), ((5,), 1), ((1, 2, 3), 0),
           ((0, 4, 5), 4), ((2,), 5), ((0, 1, 2, 3, 4, 5), 0)]


@pytest.fixture(scope="module")
def server_case():
    jm = JDecoderLM(JLMConfig(**_TINY))
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    deltas = [tree_map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32) * 1e-2, params) for _ in _MERGES]
    return jm.unit_layout(), params, deltas


@pytest.mark.parametrize("rule", ["halos", "delayed-nesterov"])
def test_global_server_merges_match_jax(server_case, rule):
    jlayout, params, deltas = server_case
    layout = DecoderLM(LMConfig(**_TINY)).unit_layout()
    jsrv = JGlobalServer(params, jlayout, JMergeConfig(rule=rule),
                         n_workers=3)
    srv = GlobalServer(params_from_numpy(params, "cpu"), layout,
                       MergeConfig(rule=rule), n_workers=3)
    assert srv.cfg == MergeConfig(rule=rule).resolve(3)
    for (units, base), d in zip(_MERGES, deltas, strict=True):
        delta = params_from_numpy(d, "cpu")
        kept = tree_map(torch.clone, delta)
        tau = srv.merge(delta, base, units)
        assert tau == jsrv.merge(tree_map(jnp.asarray, d), base, units)
        _equal(delta, kept)                      # the delta is left alone
        state, jstate = srv.state(), jax.device_get(jsrv.state())
        _close(state, jstate, 1e-6, 1e-6)
        assert srv.meta() == jsrv.meta()
    if rule == "delayed-nesterov":
        assert srv.dn_count == jsrv.dn_count == len(_MERGES) % 3


def test_local_server_take_and_average_match_jax(server_case):
    _, params, deltas = server_case
    pushes = [(0, 1, 0, (0, 1), 3), (2, 0, 1, (2,), 1),
              (1, 0, 0, (4, 5), 2), (0, 1, 1, (3,), 3)]
    srv, jsrv = LocalServer(1), JLocalServer(1)
    for (w, p, h, units, base), d in zip(pushes, deltas, strict=False):
        srv.push(params_from_numpy(d, "cpu"), units, base, worker=w,
                 period=p, phase=h)
        jsrv.push(tree_map(jnp.asarray, d), units, base, worker=w,
                  period=p, phase=h)
    want = [(1, 0, 0), (0, 1, 0), (2, 0, 1)]
    taken, jtaken = srv.take(want), jsrv.take(want)
    assert [e.key for e in taken] == [e.key for e in jtaken] == want
    assert srv.describe() == jsrv.describe()
    with pytest.raises(KeyError, match="missing"):
        srv.take([(5, 5, 5)])
    for entries, jentries in ((taken, jtaken), (taken[:1], jtaken[:1])):
        avg, units, base = LocalServer.merged_delta(entries)
        javg, junits, jbase = JLocalServer.merged_delta(jentries)
        assert (units, base) == (junits, jbase)
        _close(avg, jax.device_get(javg), 1e-6, 1e-6)


def _port_runner(scenario, *, run_cfg=AsyncRunnerConfig(), ckpt=None,
                 data=None, params=None, step_cfg=StepConfig(),
                 profile=None):
    model = DecoderLM(LMConfig(**_TINY))
    w = scenario.n_workers
    profile = profile or analytic_profile(
        model.layer_costs(4, SEQ), HardwareSpec(bandwidth=1e9, n_workers=w))
    from repro_torch.data import MarkovCorpus
    data = data or MarkovCorpus(vocab=64, seq_len=SEQ, batch_per_worker=4,
                                n_workers=w, seed=0)
    return AsyncHierRunner(
        model, make_optimizer("adam", lr=3e-3, warmup_steps=5,
                              decay_steps=400),
        get_strategy("dreamddp"), data, profile=profile, scenario=scenario,
        H=H, seed=0, ckpt=ckpt, run_cfg=run_cfg, params=params,
        step_cfg=step_cfg, device="cpu")


def _scenario(cls, link, leave, join, *, n_workers=WORKERS, events=True,
              dcs=2):
    return cls(name=f"tiny-{n_workers}w", description="",
               n_workers=n_workers, n_datacenters=dcs,
               # links fast enough beside the tiny model's compute that
               # merges land between pulls and periods
               intra=link(bandwidth=1e12, latency=1e-7, jitter=0.0),
               inter=(link(bandwidth=2e11, latency=1e-6, jitter=0.0)
                      if dcs > 1 else None),
               drift={},
               events=((leave(period=1, iteration=None, n=1),
                        join(period=2, iteration=None, n=1))
                       if events else ()),
               periods=PERIODS, seed=0)


def test_pull_base_survives_a_merge():
    """A merge lands between worker 0's pull and its delta: the base is
    the model as pulled, so the delta is taken against it."""
    r = _port_runner(_scenario(Scenario, LinkSpec, WorkerLeave, WorkerJoin,
                               events=False, dcs=1))
    r._pull(0)
    pulled = tree_map(torch.clone, r.server.params)
    delta = tree_map(torch.ones_like, r.server.params)
    r.server.merge(delta, 0, tuple(range(6)))
    assert not torch.equal(tree_leaves(pulled)[0],
                           tree_leaves(r.server.params)[0])
    _equal(r._bases[0], pulled)
    tree_map(lambda p: p.add_(0.5), r.states[0].params)
    got = r._delta(0)
    _equal(got, tree_map(lambda p, b: p[0] - b, r.states[0].params, pulled))


# ---------------------------------------------------------------------------
# runner against the JAX runner
# ---------------------------------------------------------------------------

class _JaxBatches:
    """The JAX corpus's batches, carried into the port."""

    def __init__(self, corpus):
        self.corpus = corpus
        self.n_workers = corpus.n_workers

    def batch(self, step):
        b = jax.device_get(self.corpus.batch(step))
        return {k: torch.from_numpy(np.array(v)).long()
                for k, v in b.items()}


_ASYNC = dict(pushes_per_merge=2)


@pytest.fixture(scope="module")
def jax_run():
    jm = JDecoderLM(JLMConfig(**_TINY))
    profile = j_analytic(jm.layer_costs(4, SEQ),
                         JHardwareSpec(bandwidth=1e9, n_workers=WORKERS))
    data = JMarkovCorpus(vocab=64, seq_len=SEQ, batch_per_worker=4,
                         n_workers=WORKERS, seed=0)
    sc = _scenario(JScenario, JLinkSpec, JWorkerLeave, JWorkerJoin)
    jr = JAsyncHierRunner(
        jm, j_make_optimizer("adam", lr=3e-3, warmup_steps=5,
                             decay_steps=400),
        j_get_strategy("dreamddp"), data, profile=profile, scenario=sc,
        H=H, seed=0, run_cfg=JRunCfg(async_cfg=JAsyncConfig(**_ASYNC)))
    init = jax.device_get(jax.tree.map(lambda x: x[0], jr._template.params))
    trace = jr.run(PERIODS)
    return {"init": init, "data": data, "fingerprint": trace.fingerprint(),
            "ops": [repr(o) for o in jr._schedule(PERIODS)[0]],
            "history": jr.history,
            "server": jax.device_get(jr.server.params),
            "staleness": jr.server.staleness_hist}


def _runner_from_jax(jax_run, **kw):
    return _port_runner(
        _scenario(Scenario, LinkSpec, WorkerLeave, WorkerJoin),
        run_cfg=AsyncRunnerConfig(async_cfg=AsyncConfig(**_ASYNC)),
        data=_JaxBatches(jax_run["data"]),
        params=params_from_numpy(jax_run["init"], "cpu"), **kw)


def test_runner_matches_jax(jax_run):
    r = _runner_from_jax(jax_run)
    trace = r.run(PERIODS)
    ops = r._schedule(PERIODS)[0]
    assert [repr(o) for o in ops] == jax_run["ops"]
    assert trace.fingerprint() == jax_run["fingerprint"]
    assert r.server.staleness_hist == jax_run["staleness"]
    # the log has the case a pull's base must survive: a merge between a
    # worker's pull and its period's delta
    merges, pulled_at, aliased = 0, {}, False
    for op in ops:
        if isinstance(op, PullOp):
            pulled_at[op.worker] = merges
        elif isinstance(op, MergeOp):
            merges += 1
        elif isinstance(op, PeriodOp):
            aliased |= pulled_at.pop(op.worker) < merges
    assert aliased and len(r.server.staleness_hist) > 1
    assert any(isinstance(o, LeaveOp) for o in ops) \
        and any(isinstance(o, JoinOp) for o in ops)
    keys = ("worker", "period", "step", "t_start", "t_end")
    assert [[h[k] for k in keys] for h in r.history] == \
        [[h[k] for k in keys] for h in jax_run["history"]]
    np.testing.assert_allclose([h["loss"] for h in r.history],
                               [h["loss"] for h in jax_run["history"]],
                               rtol=1e-5)
    # the tolerance of the module docstring
    fm, fr = _flat(r.server.params), _flat(jax_run["server"])
    assert sorted(fm) == sorted(fr)
    for k in fm:
        got, want = _np(fm[k]), np.asarray(fr[k])
        d = np.abs(got - want)
        assert d.max() <= 1e-4 and \
            (d > 1e-5 + 1e-5 * np.abs(want)).mean() <= 1e-3, \
            (k, float(d.max()))


def test_elastic_join_and_leave(jax_run):
    r = _runner_from_jax(jax_run)
    r.run(PERIODS)
    ops = r._schedule(PERIODS)[0]
    (join,) = [o for o in ops if isinstance(o, JoinOp)]
    (leave,) = [o for o in ops if isinstance(o, LeaveOp)]
    assert leave.worker not in r.states and join.worker in r.states
    assert any(h["worker"] == join.worker for h in r.history)
    # the joiner started from a fresh optimizer state and trained
    assert int(r.states[join.worker].step) > 0
    assert len(r.history) == PERIODS * WORKERS


def test_checkpoint_restore_replays_bitwise(jax_run, tmp_path):
    ref = _runner_from_jax(jax_run)
    ref_trace = ref.run(PERIODS)
    d = str(tmp_path)
    ck = _runner_from_jax(jax_run, ckpt=CheckpointManager(d, keep=50))
    ck.run_cfg = AsyncRunnerConfig(async_cfg=AsyncConfig(**_ASYNC),
                                   ckpt_every_merges=3)
    assert ck.run(PERIODS).fingerprint() == ref_trace.fingerprint()
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir()
                   if p.name.startswith("step_"))
    assert len(steps) >= 2
    mid = steps[len(steps) // 2]
    res = _runner_from_jax(jax_run, ckpt=CheckpointManager(d, keep=50))
    assert res.restore(step=mid) == mid and 0 < res.cursor
    assert res.run(PERIODS).fingerprint() == ref_trace.fingerprint()
    _equal(res.server.params, ref.server.params)
    _equal(res.server.momentum, ref.server.momentum)
    assert sorted(res.states) == sorted(ref.states)
    for w in ref.states:
        _equal(res.states[w], ref.states[w])
    # the restored run's history holds the periods after the checkpoint
    assert 0 < len(res.history) < len(ref.history)
    assert res.history == ref.history[len(ref.history) - len(res.history):]


def test_run_is_single_shot_and_mean_only():
    sc = _scenario(Scenario, LinkSpec, WorkerLeave, WorkerJoin,
                   n_workers=2, events=False, dcs=1)
    r = _port_runner(sc)
    r.run(2)
    with pytest.raises(ValueError, match="op-log replay cannot extend"):
        r.run(3)
    r.run(2)                         # the same total: a no-op replay
    with pytest.raises(ValueError, match="mean sync policy"):
        _port_runner(sc, step_cfg=StepConfig(compress="int8_ef"))


# ---------------------------------------------------------------------------
# Session and CLI
# ---------------------------------------------------------------------------

def _job(**kw):
    return JobConfig(**{**dict(algo="hier-async", workers=2, period=H,
                               seq=SEQ, batch_per_worker=4, lr=3e-3,
                               warmup_steps=5, decay_steps=400), **kw})


def test_session_async_fit_is_the_runner(tmp_path):
    job = _job()
    # parameters carried in (``params=``), not the seed's
    params = DecoderLM(LMConfig(**_TINY)).init(
        torch.Generator().manual_seed(5))
    sess = Session(job, model=DecoderLM(LMConfig(**_TINY)), params=params,
                   device="cpu")
    assert sess.use_async and sess.merge_config.rule == "halos"
    with pytest.raises(ValueError, match="whole periods"):
        sess.fit(H + 1)
    sess.fit(3 * H)
    r = _port_runner(sess._static_scenario(), profile=sess.profile(),
                     run_cfg=AsyncRunnerConfig(async_cfg=sess.async_config),
                     params=params)
    r.run(3)
    assert sess.runner.trace.fingerprint() == r.trace.fingerprint()
    _equal(sess.runner.server.params, r.server.params)
    assert [h["loss"] for h in sess.history] == \
        [h["loss"] for h in r.history]
    for x, g in zip(tree_leaves(sess.state.params),
                    tree_leaves(r.server.params), strict=True):
        assert x.shape == (2, *g.shape) and torch.equal(x[1], g)
    toks = sess.serve().generate(torch.zeros(1, 4, dtype=torch.long), 3)
    assert toks.shape == (1, 3)
    with pytest.raises(ValueError, match="running async session"):
        sess.replan(bandwidth=1e8)
    with pytest.raises(ValueError, match="cannot extend"):
        sess.fit(H)
    # a checkpointing session, restored into a fresh one, ends the same
    ck = Session(_job(ckpt_dir=str(tmp_path), ckpt_every=4),
                 model=DecoderLM(LMConfig(**_TINY)), params=params,
                 device="cpu")
    ck.fit(3 * H)
    again = Session(_job(ckpt_dir=str(tmp_path)),
                    model=DecoderLM(LMConfig(**_TINY)), params=params,
                    device="cpu")
    assert again.restore() == ck.runner.server.version
    again.fit(3 * H)
    _equal(again.runner.server.params, r.server.params)


def test_session_params_start_the_sync_mode_too():
    params = DecoderLM(LMConfig(**_TINY)).init(
        torch.Generator().manual_seed(5))
    sess = Session(_job(algo="dreamddp"), model=DecoderLM(LMConfig(**_TINY)),
                   params=params, device="cpu")
    for x, p in zip(tree_leaves(sess.state.params), tree_leaves(params),
                    strict=True):
        assert torch.equal(x[0], p) and torch.equal(x[1], p)
        assert x.data_ptr() != p.data_ptr()


def test_train_cli_async_on_the_cpu(capsys):
    from repro_torch.launch.train import main
    assert main(["--smoke", "--device", "cpu", "--async", "--steps", "6",
                 "--workers", "2", "--batch-per-worker", "2", "--seq",
                 "16", "--period", "2", "--merge-rule", "delayed-nesterov",
                 "--staleness-beta", "0.8"]) == 0
    out = capsys.readouterr().out
    assert "exec=async" in out and "merge: rule=delayed-nesterov" in out
    assert "beta=0.8" in out and "steps=6" in out
