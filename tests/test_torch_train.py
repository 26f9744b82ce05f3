"""The port's training path against the JAX package's, on the CPU.

* **Model** — loss and gradients of the tiny ``LMConfig`` of
  ``tests/test_api.py`` (4 layers, d_model 48, float32) with the JAX
  parameters converted, with and without remat; ``unit_layout`` and
  ``layer_costs`` exactly equal.  Tolerance ``rtol=atol=1e-5``: float32
  matmuls sum in another order in XLA:CPU and in torch.
* **Session** — ``Session.fit`` for ``dreamddp``, ``dreamddp-int8``,
  ``flsgd`` and ``ssgd`` against the JAX **per-step** session
  (``fused_period=False``; the JAX pipeline is not bitwise on this jax,
  ROADMAP.md C1), from the JAX session's initial parameters and on the
  JAX corpus's batches, loaded in the test: per-step losses within
  ``rtol=1e-5`` (``1e-4`` with int8 syncs, after the code flips below);
  final parameters 99.9% (99% with int8 syncs, where a flipped code
  moves every worker's synced value) within ``atol=2e-5`` (the
  summation order above, plus the fused AdamW's float32 ``1 - beta2``,
  1.3e-5 relative in ``v``) and all within 1e-3 — Adam turns the
  rounding noise of a near-zero gradient into a step of up to lr — or,
  with int8 syncs, 5e-3: a value near a rounding boundary may take the
  next code, one quantum (~2e-3) of its row's scale.
  The ``compiled`` period executor (its period body without a graph on
  the CPU) is held to the same JAX oracle.
* **Runner** — the port's fused ``pipeline`` and ``compiled`` executors
  bitwise equal to its own per-step path (states and losses, H = 1, 3
  and 5), straggler requeue giving the JAX runner's ``pending_units`` and
  ``skipped_syncs``; a restart from a checkpoint bitwise equal to an
  uninterrupted run on all three paths; failure recovery and elastic
  restore against the JAX runner's (losses within the per-step ``rtol``
  above, parameters within its tolerances); ``Session(ckpt_dir=...)``
  resuming; the period body making no host read (what a CUDA graph
  capture would break on).
* **Entry points** — the default ``Session(JobConfig()).fit(10)`` (granite
  smoke, dreamddp, 8 workers, H=5, adam, fused pipeline) on the CPU, the
  GPU default raising without a card, the CLI, and what is not ported
  yet (other architectures) raising.  The async runtime and SimNet,
  ported since, are held to the JAX package in ``tests/test_torch_hier.py``
  and ``tests/test_torch_sim.py``.

The card's twins (CUDA graphs, bitwise against ``pipeline``) are in
``tests/test_torch_train_graphs.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.api import JobConfig as JJobConfig  # noqa: E402
from repro.api import Session as JSession  # noqa: E402
from repro.data import MarkovCorpus as JMarkovCorpus  # noqa: E402
from repro.models.transformer import DecoderLM as JDecoderLM  # noqa: E402
from repro.models.transformer import LMConfig as JLMConfig  # noqa: E402
from repro_torch.api import JobConfig, Session  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import MarkovCorpus  # noqa: E402
from repro_torch.models.transformer import DecoderLM, LMConfig  # noqa: E402
from repro_torch.runtime import (Runner, RunnerConfig,  # noqa: E402
                                 StepConfig, init_train_state)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(1)

_TINY = dict(name="t", n_layers=4, d_model=48, n_heads=4, n_kv_heads=2,
             d_ff=96, vocab=64, param_dtype="float32", remat=False)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _params_match(a, b, worst, share, bulk=2e-5):
    """All but ``share`` of each leaf within ``bulk``, all within
    ``worst`` (Adam's amplification of near-zero gradients, see the
    module docstring)."""
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        d = np.abs(_np(fa[k]) - _np(fb[k]))
        assert d.max() <= worst and (d > bulk).mean() < share, \
            (k, float(d.max()), float((d > bulk).mean()))


def _tree_close(a, b, rtol, atol):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_allclose(_np(fa[k]), _np(fb[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# model: loss, grads, layout, costs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jm = JDecoderLM(JLMConfig(**_TINY))
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, _TINY["vocab"], (2, 16)).astype(np.int32)
    return jm, jp, toks


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(tiny, remat):
    jm, jp, toks = tiny
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(jp, batch)
    tm = DecoderLM(LMConfig(**{**_TINY, "remat": remat}))
    tp = tree_map(lambda x: x.requires_grad_(), params_from_numpy(jp, "cpu"))
    t = torch.from_numpy(toks).long()
    loss = tm.loss(tp, {"tokens": t, "labels": t}, segment_cuts=(1, 3))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _tree_close(tree_map(lambda x: x.grad, tp), jax.device_get(jgrads),
                1e-5, 1e-5)


def test_unit_layout_and_layer_costs_match_jax(tiny):
    jm = tiny[0]
    tm = DecoderLM(LMConfig(**_TINY))
    assert [dataclasses.astuple(e) for e in tm.unit_layout().entries] == \
        [dataclasses.astuple(e) for e in jm.unit_layout().entries]
    for mode in ("train", "decode"):
        assert tm.layer_costs(4, 32, mode=mode) == \
            jm.layer_costs(4, 32, mode=mode)
    assert tm.param_count() == jm.param_count()
    from repro.configs import granite_3_2b as jg
    from repro_torch.configs import granite_3_2b as tg
    for jc, tc in ((jg.SMOKE, tg.SMOKE), (jg.CONFIG, tg.CONFIG)):
        assert DecoderLM(tc).layer_costs(4, 512) == \
            JDecoderLM(jc).layer_costs(4, 512)
        tm = DecoderLM(tc)
        tm.unit_layout().validate_against(
            tm.init(torch.Generator().manual_seed(0)) if tc is tg.SMOKE
            else {"embed": {}, "blocks": {"w": torch.empty(0, 40)},
                  "head": {}})


# ---------------------------------------------------------------------------
# Session.fit against the JAX per-step session
# ---------------------------------------------------------------------------

class _JaxBatches:
    """The JAX corpus's batches, carried into the port."""

    def __init__(self, corpus):
        self.corpus = corpus

    def batch(self, step):
        b = jax.device_get(self.corpus.batch(step))
        return {k: torch.from_numpy(np.array(v)).long()
                for k, v in b.items()}

    def entropy_floor(self):
        return self.corpus.entropy_floor()


def _job(algo, **kw):
    return dict(algo=algo, workers=2, period=2, seq=16, batch_per_worker=2,
                lr=3e-3, warmup_steps=2, decay_steps=50, **kw)


def _jax_session(algo, steps):
    js = JSession(JJobConfig(**_job(algo, fused_period=False)),
                  model=JDecoderLM(JLMConfig(**_TINY)))
    init = jax.device_get(js.state.params)
    js.fit(steps)
    return js, init


def _load(state, params_np):
    """Overwrite the port's initial parameters with the JAX ones."""
    for t, a in zip(tree_leaves(state.params), tree_leaves(params_np),
                    strict=True):
        t.copy_(torch.from_numpy(np.array(a)))


@pytest.mark.parametrize("algo,exec_", [
    pytest.param("dreamddp", "pipeline", id="dreamddp"),
    pytest.param("dreamddp-int8", "pipeline", id="dreamddp-int8"),
    pytest.param("flsgd", "pipeline", id="flsgd"),
    pytest.param("ssgd", "pipeline", id="ssgd"),
    pytest.param("dreamddp", "compiled", id="dreamddp-compiled"),
    pytest.param("dreamddp-int8", "compiled", id="dreamddp-int8-compiled"),
])
def test_session_fit_matches_jax_per_step(algo, exec_):
    steps = 6
    js, init = _jax_session(algo, steps)
    cfg = JobConfig(**_job(algo, period_exec=exec_))
    ts = Session(cfg, model=DecoderLM(LMConfig(**_TINY)),
                 data=_JaxBatches(JMarkovCorpus(
                     vocab=_TINY["vocab"], seq_len=cfg.seq,
                     batch_per_worker=cfg.batch_per_worker,
                     n_workers=cfg.workers, seed=cfg.seed)),
                 device="cpu")
    assert ts.plan.fingerprint() == js.plan.fingerprint()
    _load(ts.state, init)
    ts.fit(steps)
    np.testing.assert_allclose([h["loss"] for h in ts.history],
                               [h["loss"] for h in js.history],
                               rtol=1e-4 if algo == "dreamddp-int8" else 1e-5)
    assert [h["step"] for h in ts.history] == list(range(steps))
    # the tolerances of the module docstring
    worst, share = (5e-3, 1e-2) if algo == "dreamddp-int8" else (1e-3, 1e-3)
    _params_match(ts.state.params, jax.device_get(js.state.params), worst,
                  share)
    assert int(ts.state.step) == steps


# ---------------------------------------------------------------------------
# runner: fused == per-step (bitwise), straggler requeue
# ---------------------------------------------------------------------------

def _port_runner(algo, *, fused, H=3, W=2, run_kw=None, **job_kw):
    sess = Session(JobConfig(**{**_job(algo), "period": H, "workers": W,
                                "fused_period": fused, **job_kw}),
                   model=DecoderLM(LMConfig(**_TINY)), device="cpu")
    if run_kw:
        sess.runner.run_cfg = dataclasses.replace(sess.runner.run_cfg,
                                                  **run_kw)
    return sess


@pytest.mark.parametrize("algo,exec_,H", [
    pytest.param("dreamddp", "pipeline", 3, id="dreamddp"),
    pytest.param("dreamddp-int8", "pipeline", 3, id="dreamddp-int8"),
    pytest.param("dreamddp", "compiled", 1, id="dreamddp-compiled-H1"),
    pytest.param("dreamddp", "compiled", 5, id="dreamddp-compiled-H5"),
    pytest.param("dreamddp-int8", "compiled", 5,
                 id="dreamddp-int8-compiled-H5"),
])
def test_fused_pipeline_bitwise_equals_per_step(algo, exec_, H):
    n = 2 * H + 2                          # two periods and a tail
    per_step = _port_runner(algo, fused=False, H=H).fit(n)
    fused = _port_runner(algo, fused=True, H=H, period_exec=exec_).fit(n)
    for a, b in zip(tree_leaves(per_step.state), tree_leaves(fused.state),
                    strict=True):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert [h["loss"] for h in per_step.history] == \
        [h["loss"] for h in fused.history]
    assert [h["step"] for h in fused.history] == list(range(n))


def _tree_state(state):
    return [x for x in tree_leaves(state._asdict()) if x is not None]


@pytest.mark.parametrize("fused", [False, True, "compiled"])
def test_straggler_requeue_matches_jax(fused):
    """``"compiled"``: the port's compiled executor (the make-up period
    body) against the JAX pipeline, and bitwise against its own
    pipeline on the same schedule."""
    from repro.api import Session as JS
    from repro.runtime import RunnerConfig as JRunnerConfig
    exec_ = "compiled" if fused == "compiled" else "pipeline"
    fused = bool(fused)
    H, n = 2, 8                            # four periods
    # a 1e4x deadline: only the injected stall (1e8 s) can trip it, not
    # JAX's first compile of the make-up step nor a busy CPU
    jrc = dict(deadline_factor=1e4, min_history=2)
    js = JS(JJobConfig(**_job("dreamddp", fused_period=fused)),
            model=JDecoderLM(JLMConfig(**_TINY)))
    jr = js.runner
    jr.run_cfg = JRunnerConfig(**{**jr.run_cfg.__dict__, **jrc})
    at = (5, 1e8)                          # phase 1 of the third period
    jstate = jr.run(js.state, 3 * H, fused=fused, inject_straggler_at=at)
    runs = []
    for mode in {exec_, "pipeline"}:
        ts = _port_runner("dreamddp", fused=fused, H=H, run_kw=jrc,
                          period_exec=mode)
        tr = ts.runner
        tstate = tr.run(ts.state, 3 * H, fused=fused, inject_straggler_at=at)
        assert tr.pending_units == jr.pending_units and tr.pending_units
        assert tr.skipped_syncs == jr.skipped_syncs == 1
        # the make-up runs at the next period start and clears the queue
        tr.run(tstate, n - 3 * H, start_step=3 * H, fused=fused)
        runs.append(tstate)
    jr.run(jstate, n - 3 * H, start_step=3 * H, fused=fused)
    assert tr.pending_units == jr.pending_units == set()
    assert len(tr.history) == len(jr.history) == n
    for a, b in zip(_tree_state(runs[0]), _tree_state(runs[-1]),
                    strict=True):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# checkpoints: restart, recovery and elastic restore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exec_", ["per-step", "pipeline", "compiled"])
def test_restart_equals_uninterrupted(exec_, tmp_path):
    """A checkpoint every period and a failure inside the second period:
    the restore (in place) and replay end bitwise where a run that never
    failed ends."""
    from repro_torch.checkpoint import CheckpointManager
    H, n = 3, 4 * 3
    fused = exec_ != "per-step"
    mode = "compiled" if exec_ == "compiled" else "pipeline"
    ok = _port_runner("dreamddp-int8", fused=fused, H=H, period_exec=mode)
    ok.fit(n)
    sess = _port_runner("dreamddp-int8", fused=fused, H=H, period_exec=mode,
                        run_kw={"ckpt_every": H})
    r = sess.runner
    r.ckpt = CheckpointManager(str(tmp_path))
    ptrs = [x.data_ptr() for x in _tree_state(sess.state)]
    state = r.run(sess.state, n, fused=fused, inject_failure_at=H + 1)
    assert r.retries == 1 and r.ckpt.latest_step() == n
    assert [x.data_ptr() for x in _tree_state(state)] == ptrs
    assert int(state.step) == n
    for a, b in zip(_tree_state(ok.state), _tree_state(state), strict=True):
        assert torch.equal(a, b)
    # the per-step path logged step H before the failure at H + 1; the
    # fused path loses the failed period's rows
    done = H if fused else H + 1
    assert [h["step"] for h in r.history] == list(range(done)) + \
        list(range(H, n))


def _mirrored(algo, tmp_path, **kw):
    """The JAX per-step session and the port's over the same initial
    parameters and batches, each with checkpoints in ``tmp_path``.  A
    1e4x straggler deadline on both: JAX's compile of a step rebuilt by
    ``replan`` must not requeue a sync the port never requeues."""
    job = _job(algo, fused_period=False, **kw)
    js = JSession(JJobConfig(**job, ckpt_dir=str(tmp_path / "jax")),
                  model=JDecoderLM(JLMConfig(**_TINY)))
    cfg = JobConfig(**job, ckpt_dir=str(tmp_path / "port"))
    ts = Session(cfg, model=DecoderLM(LMConfig(**_TINY)),
                 data=_JaxBatches(JMarkovCorpus(
                     vocab=_TINY["vocab"], seq_len=cfg.seq,
                     batch_per_worker=cfg.batch_per_worker,
                     n_workers=cfg.workers, seed=cfg.seed)),
                 device="cpu")
    _load(ts.state, jax.device_get(js.state.params))
    for r in (js.runner, ts.runner):
        r.run_cfg = dataclasses.replace(r.run_cfg, deadline_factor=1e4)
    return js, ts


def _histories_match(jr, tr):
    assert [h["step"] for h in tr.history] == [h["step"] for h in jr.history]
    np.testing.assert_allclose([h["loss"] for h in tr.history],
                               [h["loss"] for h in jr.history], rtol=1e-5)


def test_failure_recovery_matches_jax(tmp_path):
    """``tests/test_train_integration.py::test_failure_recovery`` on both
    runners: a checkpoint every 4 steps, a failure at step 7, the same
    replay (steps 0-6, then 4-11) and states within the per-step
    tolerances."""
    js, ts = _mirrored("dreamddp", tmp_path, ckpt_every=4)
    jr, tr = js.runner, ts.runner
    jr.ckpt.save(0, js.state, block=True)
    tr.ckpt.save(0, ts.state, block=True)
    jstate = jr.run(js.state, 12, inject_failure_at=7)
    tstate = tr.run(ts.state, 12, inject_failure_at=7)
    assert tr.retries == jr.retries == 1
    assert [h["step"] for h in tr.history] == list(range(7)) + \
        list(range(4, 12))
    _histories_match(jr, tr)
    assert tr.skipped_syncs == jr.skipped_syncs == 0
    _params_match(tstate.params, jax.device_get(jstate.params), 1e-3, 1e-3)


def test_elastic_restore_matches_jax(tmp_path):
    """``tests/test_train_integration.py::test_elastic_restore`` on both
    runners: 8 steps on 2 workers, then the reference's step-8
    checkpoint through both ``restore_elastic`` onto 4 workers (replicas
    averaged) with a plan re-solved for them, then 4 more steps.  The
    same checkpoint goes into both, so each stretch starts from equal
    inputs, as the session test does."""
    from repro.runtime import init_train_state as jinit
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.optim import make_optimizer
    js, ts = _mirrored("dreamddp", tmp_path, ckpt_every=8)
    jr, tr = js.runner, ts.runner
    jr.run(js.state, 8)
    tr.run(ts.state, 8)
    _histories_match(jr, tr)
    assert tr.ckpt.latest_step() == 8
    tr.ckpt = CheckpointManager(str(tmp_path / "jax"))
    jplan = js.strategy.build_plan(js.profile().with_bandwidth(
        1e9, js.cfg.latency, 4), js.cfg.period)
    tplan = ts.strategy.build_plan(ts.profile().with_bandwidth(
        1e9, ts.cfg.latency, 4), ts.cfg.period)
    assert tplan.fingerprint() == jplan.fingerprint()
    jstep, jstate = jr.restore_elastic(
        jinit(js.model, js._opt, jax.random.PRNGKey(0), 4), 4, jplan)
    tstep, tstate = tr.restore_elastic(
        init_train_state(ts.model, make_optimizer("adam"),
                         torch.Generator().manual_seed(0), 4), 4, tplan)
    assert tstep == jstep == 8 and tr.plan is tplan
    assert all(x.shape[0] == 4 for x in tree_leaves(tstate.params))
    _tree_close(tstate.params, jax.device_get(jstate.params), 1e-6, 0)
    _tree_close(tstate.opt_state, jax.device_get(jstate.opt_state), 1e-6, 0)
    corpus = dict(vocab=_TINY["vocab"], seq_len=ts.cfg.seq,
                  batch_per_worker=ts.cfg.batch_per_worker, n_workers=4,
                  seed=0)
    jr.data = JMarkovCorpus(**corpus)
    tr.data = _JaxBatches(JMarkovCorpus(**corpus))
    jstate = jr.run(jstate, 4, start_step=jstep)
    tstate = tr.run(tstate, 4, start_step=tstep)
    _histories_match(jr, tr)
    assert tr.skipped_syncs == jr.skipped_syncs == 0
    _params_match(tstate.params, jax.device_get(jstate.params), 1e-3, 1e-3)


@pytest.mark.parametrize("exec_", ["pipeline", "compiled"])
def test_session_ckpt_dir_resumes(exec_, tmp_path):
    """A session over ``ckpt_dir`` saves every period; a fresh session
    over the same directory restores the latest one in place and trains
    on bitwise as the first does."""
    H = 2
    job = dict(period_exec=exec_, ckpt_dir=str(tmp_path), ckpt_every=H)
    a = _port_runner("dreamddp", fused=True, H=H, **job).fit(2 * H)
    b = _port_runner("dreamddp", fused=True, H=H, **job)
    ptrs = [x.data_ptr() for x in _tree_state(b.state)]
    assert b.restore() == 2 * H
    assert [x.data_ptr() for x in _tree_state(b.state)] == ptrs
    a.fit(H)
    b.fit(H)
    assert [h["step"] for h in b.history] == list(range(2 * H, 3 * H))
    assert [h["loss"] for h in b.history] == \
        [h["loss"] for h in a.history[2 * H:]]
    for x, y in zip(_tree_state(a.state), _tree_state(b.state), strict=True):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="ckpt_dir"):
        _port_runner("dreamddp", fused=True).restore()


@pytest.mark.parametrize("algo", ["dreamddp", "dreamddp-int8"])
def test_period_body_reads_nothing_back_to_the_host(algo, monkeypatch):
    """What a CUDA graph capture cannot take fails here: after one
    period (the warm-up the card runs before it captures), the period
    body — remat on, a make-up phase 0 included — may not turn a tensor
    into a Python value or build one from host data."""
    from repro_torch.runtime.pipeline import stack_period_batches
    from repro_torch.runtime.step import make_period_step
    sess = Session(JobConfig(**{**_job(algo, period_exec="compiled"),
                                "period": 3}),
                   model=DecoderLM(LMConfig(**{**_TINY, "remat": True})),
                   device="cpu")
    sess.fit(3)
    r = sess.runner
    batch = stack_period_batches(r.data, 3, 3)
    bodies = [r._period_step(()), make_period_step(
        r.model, r.optimizer, r.plan, cfg=r.step_cfg, makeup_units=(0, 2))]

    def host_read(*a, **k):
        raise AssertionError("host read inside the period body")

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "numpy", "cpu", "__bool__",
                     "__int__", "__float__", "__index__"):
            m.setattr(torch.Tensor, name, host_read)
        m.setattr(torch, "tensor", host_read)
        for body in bodies:
            _, metrics = body(sess.state, batch)
    assert metrics["loss"].shape == (3,)
    assert int(sess.state.step) == 9


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_default_job_fits_on_the_cpu():
    sess = Session(JobConfig(), device="cpu")
    cfg = sess.cfg
    assert (cfg.arch, cfg.algo, cfg.workers, cfg.period, cfg.optimizer,
            cfg.fused_period, cfg.period_exec) == \
        ("granite-3-2b", "dreamddp", 8, 5, "adam", True, "pipeline")
    sess.fit(10)
    losses = [h["loss"] for h in sess.history]
    assert len(losses) == 10 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert all(x.shape[0] == 8 for x in tree_leaves(sess.state.params))
    assert int(sess.state.step) == 10


def test_gpu_is_the_default_and_cpu_must_be_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Session(JobConfig())


def test_replan_reshards_workers_and_keeps_training():
    sess = _port_runner("dreamddp", fused=True, W=2).fit(3)
    plan = sess.replan(workers=3, bandwidth=1e8)
    assert plan.meta["n_workers"] == 3
    assert all(x.shape[0] == 3 for x in tree_leaves(sess.state.params))
    sess.fit(3)
    assert len(sess.history) == 6 and np.isfinite(
        [h["loss"] for h in sess.history]).all()


def test_what_is_not_ported_raises():
    model = DecoderLM(LMConfig(**_TINY))
    # the async runtime and SimNet no longer raise: hier-async trains
    # whole periods (a partial one is refused) and simulate replays
    sess = Session(JobConfig(**_job("hier-async")), model=model,
                   device="cpu")
    with pytest.raises(ValueError, match="whole periods"):
        sess.fit(3)
    sess = Session(JobConfig(**_job("dreamddp")), model=model, device="cpu")
    assert sess.simulate("churn").trace.n_periods > 0
    with pytest.raises(KeyError, match="unknown arch"):
        Session(JobConfig(arch="llava-next-35b"), device="cpu").model
    from repro_torch.serve import ServeEngine
    assert isinstance(sess.serve(), ServeEngine)
    assert Session(JobConfig(algo="hier-2tier"), model=model,
                   device="cpu").plan.algo == "hier-2tier"


def test_markov_corpus_is_a_function_of_the_step():
    a = MarkovCorpus(vocab=64, seq_len=12, batch_per_worker=3, n_workers=2,
                     seed=1)
    b = MarkovCorpus(vocab=64, seq_len=12, batch_per_worker=3, n_workers=2,
                     seed=1)
    assert torch.equal(a.batch(5)["tokens"], b.batch(5)["tokens"])
    assert not torch.equal(a.batch(5)["tokens"], a.batch(6)["tokens"])
    toks = a.batch(0)["tokens"]
    assert toks.shape == (2, 3, 12) and 0 <= int(toks.min()) \
        and int(toks.max()) < 64
    j = JMarkovCorpus(vocab=64, seq_len=12, batch_per_worker=3, n_workers=2,
                      seed=1)
    assert a.entropy_floor() == pytest.approx(j.entropy_floor(), rel=1e-6)
    # every transition the chain takes is one of the table's
    nexts = a._nexts
    t = toks.reshape(-1, 12).numpy()
    for row in t:
        for x, y in zip(row[:-1], row[1:]):
            assert y in nexts[x]


def test_train_cli_on_the_cpu(capsys):
    from repro_torch.launch.train import main
    assert main(["--smoke", "--device", "cpu", "--steps", "4", "--workers",
                 "2", "--batch-per-worker", "2", "--seq", "16", "--period",
                 "2", "--algo", "dreamddp-int8"]) == 0
    out = capsys.readouterr().out
    assert "steps=4" in out and "fingerprint=" in out


def test_init_train_state_is_identical_replicas():
    model = DecoderLM(LMConfig(**_TINY))
    from repro_torch.optim import make_optimizer
    st = init_train_state(model, make_optimizer("adam"),
                          torch.Generator().manual_seed(0), 3,
                          cfg=StepConfig(compress="int8_ef"))
    for x in tree_leaves(st.params):
        assert torch.equal(x[0], x[2])
    assert st.ef is not None and st.step.dtype == torch.int32
    r = Runner(model, make_optimizer("adam"), Session(
        JobConfig(**_job("dreamddp")), model=model, device="cpu").plan,
        None, run_cfg=RunnerConfig())
    assert len(r._steps) == r.plan.H


def test_microbatched_step_matches_jax(tiny):
    """``n_microbatches=2``: the batch arrives ``[W, 2, B/2, S]`` and
    float32-accumulated gradients are averaged, as in the reference."""
    from repro.core.plans import local_plan as jax_local_plan
    from repro.optim import make_optimizer as jax_make_optimizer
    from repro.runtime import StepConfig as JStepConfig
    from repro.runtime.step import init_train_state as jax_init
    from repro.runtime.step import make_train_step as jax_make_step
    from repro_torch.core.plans import local_plan
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime.step import make_train_step
    jm, jp, _ = tiny
    rng = np.random.default_rng(3)
    toks = rng.integers(0, _TINY["vocab"], (2, 2, 2, 8)).astype(np.int32)
    jopt = jax_make_optimizer("adam", lr=1e-2, warmup_steps=1)
    jstate = jax_init(jm, jopt, jax.random.PRNGKey(0), 2)
    jstep = jax_make_step(jm, jopt, jax_local_plan(6), 0,
                          cfg=JStepConfig(n_microbatches=2))
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    jnew, jmet = jax.jit(jstep)(jstate, jbatch)
    tm = DecoderLM(LMConfig(**_TINY))
    topt = make_optimizer("adam", lr=1e-2, warmup_steps=1)
    tstate = init_train_state(tm, topt, torch.Generator().manual_seed(0), 2,
                              cfg=StepConfig(n_microbatches=2))
    _load(tstate, jax.device_get(jstate.params))
    tstep = make_train_step(tm, topt, local_plan(6), 0,
                            cfg=StepConfig(n_microbatches=2))
    t = torch.from_numpy(toks).long()
    tnew, tmet = tstep(tstate, {"tokens": t, "labels": t})
    np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]),
                               rtol=1e-5)
    # Adam's first step is ~lr * sign(g): only a gradient near eps can
    # land elsewhere
    _params_match(tnew.params, jax.device_get(jnew.params), 1e-2, 1e-3)
