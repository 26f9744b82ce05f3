"""The training loop: ``Session(JobConfig(...)).fit`` on the compiled
period runner, rows drawn from the seed.

Set-up builds one session (the benchmark's weights and rows) and takes
its first step alone (``fit(1)``, the runner's per-step path, the body a
period runs for its phase): AdamW's first moment then gives the first
gradient as the optimizer got it.  It completes that period step by
step and runs one period eagerly (the compiled runner's first), which
warms every shape.  Then it puts the seed's weights back into the
state's own tensors, zeroes AdamW's moments, the error feedback and the
step counter in place, and calls ``fit(H)`` as the window does: the
period is captured as a CUDA graph and replayed.  That period is what
the check reads besides the first gradient: its ``H`` losses, AdamW's
first moment and the change of every leaf.  The window is ``fit(H)``
again and again, each a replay of the same graph on the same state,
until ``--seconds`` have passed; a loss of the window that is not finite
fails the run.  A traced run then profiles one more period.  After the
window the session is freed and the reference repeats the first step
and the checked period.
"""

from __future__ import annotations

import gc
import math

import numpy as np
import torch

from .. import reference
from ..weights import dense_leaves, dense_params, draw_leaf, flatten


class SeededRows:
    """The training rows: ``batch(step)`` -> ``{tokens, labels}`` int64
    ``[W, B, S]``, uniform over the vocabulary, a pure function of
    ``(seed, step)``; every row of every step differs."""

    def __init__(self, vocab: int, workers: int, batch: int, seq: int,
                 seed: int):
        self.shape = (workers, batch, seq)
        self.vocab, self.seed = vocab, seed

    def tokens(self, step: int) -> torch.Tensor:
        rng = np.random.default_rng([self.seed, step])
        return torch.from_numpy(rng.integers(0, self.vocab, self.shape))

    def batch(self, step: int) -> dict:
        t = self.tokens(int(step))
        return {"tokens": t, "labels": t}


def job_config(run):
    """The program's job for this cell, and the reference's view of it."""
    from repro_torch.api import JobConfig
    from repro_torch.optim.optimizers import OptConfig
    t = run.traffic["job"]
    opt = OptConfig()
    for key in ("beta1", "beta2", "eps", "grad_clip", "min_lr_ratio"):
        if getattr(opt, key) != t[key]:
            raise ValueError(f"the program's AdamW {key} is "
                             f"{getattr(opt, key)}, the job states {t[key]}")
    job = JobConfig(
        arch=run.config["name"], algo=t["algo"],
        workers=run.config["workers"], period=t["period"],
        batch_per_worker=t["batch_per_worker"], seq=t["seq"], smoke=False,
        optimizer="adamw", lr=t["lr"], warmup_steps=t["warmup_steps"],
        decay_steps=t["decay_steps"], weight_decay=t["weight_decay"],
        bandwidth=t["plan"]["bandwidth"], latency=t["plan"]["latency"],
        seed=run.seed, period_exec="compiled")
    ref_job = dict(t, workers=run.config["workers"])
    return job, ref_job


def leaf_norms(tree: dict) -> dict:
    return {p: float(t.float().norm()) for p, t in flatten(tree).items()}


def restart(state, m: dict, seed: int, device, dtype) -> None:
    """The state back at the start, in its own tensors: the seed's
    weights in every worker, AdamW's moments, the error feedback and the
    step counter at zero."""
    if state.outer is not None:
        raise ValueError("the benchmark's training cells run no outer "
                         "optimizer")
    params = flatten(state.params)
    for i, (path, _, _) in enumerate(dense_leaves(m)):
        params[path].copy_(draw_leaf(m, seed, i, device, dtype)
                           .expand_as(params[path]))
    for tree in (state.opt_state, state.ef or {}):
        for t in flatten(tree).values():
            if t is not None:
                t.zero_()
    state.step.zero_()


def drive(run) -> None:
    from repro_torch.api import Session

    model, m = run.model()
    t = run.traffic["job"]
    H, W = t["period"], run.config["workers"]
    job, ref_job = job_config(run)
    rows = SeededRows(m["vocab"], W, t["batch_per_worker"], t["seq"],
                      run.seed)
    dtype = getattr(torch, m["dtype"])
    params = dense_params(m, run.seed, run.device, dtype)
    sess = Session(job, model=model, data=rows, params=params,
                   device=run.device)
    sess.state                                    # builds the replicas
    del params
    run.mark("replicas built")
    policy = sess.step_config.policy.name
    if policy != t["sync"]:
        raise ValueError(f"{t['algo']} syncs by {policy}, the job states "
                         f"{t['sync']}")
    plan_units = [tuple(u) for u in sess.plan.phase_units]

    sess.fit(1)
    one_minus_b1 = 1.0 - torch.tensor(t["beta1"], dtype=torch.float32)
    grad = {p: n / float(one_minus_b1) for p, n in
            leaf_norms(sess.state.opt_state["m"]).items()}
    sess.fit(H - 1)
    sess.fit(H)
    run.mark("a period step by step, and an eager one")
    # the checked period: a fresh start, captured and replayed as the
    # window's periods are
    restart(sess.state, m, run.seed, run.device, dtype)
    first = len(sess.history)
    sess.fit(H)
    stats = sess.runner.graph_stats
    run.mark(f"captured ({stats.capture_s:.3f} s) and replayed")
    graphs = run.device == "cuda"      # on the CPU the body runs as it is
    if graphs and (stats.graphs != 1 or stats.replays[()] != 1):
        raise RuntimeError(f"set-up captured {stats.graphs} periods and "
                           f"replayed {dict(stats.replays)}, want 1 and 1")
    losses = [h["loss"] for h in sess.history[first:]]
    moment = leaf_norms(sess.state.opt_state["m"])
    change = {}
    leaves = flatten(sess.state.params)
    for i, (path, _, _) in enumerate(dense_leaves(m)):
        p0 = draw_leaf(m, run.seed, i, run.device, dtype).float()
        # a worker at a time: the state nearly fills the card
        change[path] = math.sqrt(sum(
            float((w.float() - p0).norm()) ** 2 for w in leaves[path]))
        del p0
    del leaves
    run.mark("checked period read")

    tokens_per_step = W * t["batch_per_worker"] * t["seq"]
    first = len(sess.history)
    run.start_window()
    periods = 0
    while True:
        sess.fit(H)
        periods += 1
        if run.elapsed() >= run.seconds:
            break
    run.end_window()
    if graphs and (stats.graphs != 1 or stats.replays[()] != periods + 1):
        raise RuntimeError(f"the window replayed {dict(stats.replays)} "
                           f"over {stats.graphs} captures, want "
                           f"{periods + 1} replays of one")
    window_losses = [h["loss"] for h in sess.history[first:]]
    steps = periods * H
    run.values.update(
        steps=steps, tokens=steps * tokens_per_step, model=m, workers=W,
        batch=t["batch_per_worker"], seq=t["seq"])

    if run.trace:
        by_shape = stats.captured_by_shape.get((), {})
        run.profile(lambda: sess.fit(H))
        # what the profiled period launched: one fused AdamW a leaf a
        # step over every worker; the int8 kernels at the captured shapes
        run.values["slice"] = {
            "steps": H,
            "param_dtype": m["dtype"],
            "adamw_leaves": [[W, *s] for _, s, _ in dense_leaves(m)],
            "int8_shapes": [[r, c, n] for (r, c), n in
                            sorted(by_shape.items())],
        }
    run.read_memory()
    del sess
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()

    run.values["train_check"] = {
        "m": m, "job": ref_job, "rows": lambda s: rows.tokens(2 * H + s),
        "first_rows": rows.tokens, "units": plan_units, "grad": grad,
        "losses": losses, "moment": moment, "change": change}
    run.mark("window and trace done, program freed")
    ref_first = reference.train_reference(m, ref_job, run.seed, rows.tokens,
                                          run.device, steps=1)
    ref = reference.train_reference(m, ref_job, run.seed,
                                    lambda s: rows.tokens(2 * H + s),
                                    run.device)
    run.compare_train(plan_units, grad, losses, moment, change,
                      ref_first, ref)
    run.mark("reference done")
    run.attempted = len(window_losses)
    run.failed = sum(not math.isfinite(x) for x in window_losses)
