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
* **Runner** — the port's fused pipeline bitwise equal to its own
  per-step path (states and losses), and straggler requeue giving the
  JAX runner's ``pending_units`` and ``skipped_syncs``.
* **Entry points** — the default ``Session(JobConfig()).fit(10)`` (granite
  smoke, dreamddp, 8 workers, H=5, adam, fused pipeline) on the CPU, the
  GPU default raising without a card, the CLI, and the parts not ported
  yet raising ``NotImplementedError``.
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


@pytest.mark.parametrize("algo", ["dreamddp", "dreamddp-int8", "flsgd",
                                  "ssgd"])
def test_session_fit_matches_jax_per_step(algo):
    steps = 6
    js, init = _jax_session(algo, steps)
    cfg = JobConfig(**_job(algo))
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

def _port_runner(algo, *, fused, H=3, W=2, run_kw=None):
    sess = Session(JobConfig(**{**_job(algo), "period": H, "workers": W,
                                "fused_period": fused}),
                   model=DecoderLM(LMConfig(**_TINY)), device="cpu")
    if run_kw:
        sess.runner.run_cfg = dataclasses.replace(sess.runner.run_cfg,
                                                  **run_kw)
    return sess


@pytest.mark.parametrize("algo", ["dreamddp", "dreamddp-int8"])
def test_fused_pipeline_bitwise_equals_per_step(algo):
    n = 2 * 3 + 2                          # two periods and a tail
    per_step = _port_runner(algo, fused=False).fit(n)
    fused = _port_runner(algo, fused=True).fit(n)
    for a, b in zip(tree_leaves(per_step.state), tree_leaves(fused.state),
                    strict=True):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert [h["loss"] for h in per_step.history] == \
        [h["loss"] for h in fused.history]
    assert [h["step"] for h in fused.history] == list(range(n))


def _tree_state(state):
    return [x for x in tree_leaves(state._asdict()) if x is not None]


@pytest.mark.parametrize("fused", [False, True])
def test_straggler_requeue_matches_jax(fused):
    from repro.api import Session as JS
    from repro.runtime import RunnerConfig as JRunnerConfig
    H, n = 2, 8                            # four periods
    # a 1e4x deadline: only the injected stall (1e8 s) can trip it, not
    # JAX's first compile of the make-up step nor a busy CPU
    jrc = dict(deadline_factor=1e4, min_history=2)
    js = JS(JJobConfig(**_job("dreamddp", fused_period=fused)),
            model=JDecoderLM(JLMConfig(**_TINY)))
    jr = js.runner
    jr.run_cfg = JRunnerConfig(**{**jr.run_cfg.__dict__, **jrc})
    ts = _port_runner("dreamddp", fused=fused, H=H, run_kw=jrc)
    tr = ts.runner
    at = (5, 1e8)                          # phase 1 of the third period
    jstate = jr.run(js.state, 3 * H, fused=fused, inject_straggler_at=at)
    tstate = tr.run(ts.state, 3 * H, fused=fused, inject_straggler_at=at)
    assert tr.pending_units == jr.pending_units and tr.pending_units
    assert tr.skipped_syncs == jr.skipped_syncs == 1
    # the make-up runs at the next period start and clears the queue
    jr.run(jstate, n - 3 * H, start_step=3 * H, fused=fused)
    tr.run(tstate, n - 3 * H, start_step=3 * H, fused=fused)
    assert tr.pending_units == jr.pending_units == set()
    assert len(tr.history) == len(jr.history) == n


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
    with pytest.raises(NotImplementedError, match="A item 10"):
        Session(JobConfig(algo="hier-async"), model=model,
                device="cpu").fit(5)
    with pytest.raises(NotImplementedError, match="item 6"):
        Session(JobConfig(ckpt_dir="ckpt"), model=model, device="cpu")
    sess = Session(JobConfig(**_job("dreamddp", period_exec="compiled")),
                   model=model, device="cpu")
    with pytest.raises(NotImplementedError, match="item 7"):
        sess.fit(3)
    with pytest.raises(NotImplementedError):
        sess.simulate("churn")
    with pytest.raises(NotImplementedError):
        sess.serve()
    with pytest.raises(NotImplementedError, match="item 6"):
        sess.runner.restore_elastic(sess.state, 2, sess.plan)
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
