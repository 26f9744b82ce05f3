"""The training loop of an MLA + MoE decoder: ``Session(JobConfig(...))
.fit`` on the compiled period runner, as :mod:`perfbench.loops.train`
drives a dense one, with this model's leaves, weights and reference.

Set-up builds one session, takes its first step alone (``fit(1)``: AdamW's
first moment gives the first gradient as the optimizer got it),
completes that period step by step and runs one period eagerly, which
warms every shape.  Around that eager period alone the loop also counts,
on the device, the (token, choice) pairs whose expert is held from the
top-k indices the program's router returned, and holds the program's
``routed_rows`` counter to that count: the counter counts every held
pair once.  (Both count from the same indices, so this shows the counter
right; that no row was dropped or misplaced in the permute or the grouped
products is shown by the check's ``grad_gap`` against the reference's
per-token loop.)  The patch is gone before the capture, so the graph
holds the program's operations alone.  Then the loop puts the seed's
weights back into the state's own tensors, zeroes AdamW's moments and
the step counter in place, and calls ``fit(H)`` as the window does: the
period is captured as a CUDA graph and replayed, and the check reads its
losses, AdamW's first moment and every leaf's change.  The window
is ``fit(H)`` again and again until ``--seconds`` have passed; a loss
that is not finite fails the run.  The rows each held expert took in the
window give the load metric; a traced run then profiles one more period,
whose routed rows and grouped-product launches give the kernel's work.
After the window the session is freed and the reference repeats the
first step and the checked period.
"""

from __future__ import annotations

import gc
import math

import torch

from .. import moe_reference
from ..moe_weights import draw_moe_leaf, flatten, moe_leaves, moe_params
from .train import SeededRows, job_config, leaf_norms


def restart(state, m: dict, seed: int, device, dtype) -> None:
    """The state back at the start, in its own tensors: the seed's
    weights in every worker, AdamW's moments and the step counter at
    zero."""
    if state.outer is not None or state.ef is not None:
        raise ValueError("the MoE training cell runs no outer optimizer "
                         "and no error feedback")
    params = flatten(state.params)
    for i, (path, _, _, _) in enumerate(moe_leaves(m)):
        params[path].copy_(draw_moe_leaf(m, seed, i, device, dtype)
                           .expand_as(params[path]))
    for t in flatten(state.opt_state).values():
        if t is not None:
            t.zero_()
    state.step.zero_()


class HeldPairs:
    """Counts, on the device, the (token, choice) pairs the program's
    router sends to a held expert, from the top-k indices it returns,
    while installed around the program's routing function."""

    def __init__(self, moe_module, first: int, held: int, device):
        self.mod, self.first, self.held = moe_module, first, held
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.calls = 0
        self._route = moe_module._route

    def _counting(self, cfg, logits):
        w, idx = self._route(cfg, logits)
        self.count += ((idx >= self.first)
                       & (idx < self.first + self.held)).sum()
        self.calls += 1
        return w, idx

    def __enter__(self):
        self.mod._route = self._counting
        return self

    def __exit__(self, *exc):
        self.mod._route = self._route


def drive(run) -> None:
    from repro_torch.api import Session
    from repro_torch.kernels.grouped_gemm import grouped_gemm
    from repro_torch.models import moe as program_moe

    model, m = run.model()
    t = run.traffic["job"]
    H, W = t["period"], run.config["workers"]
    job, ref_job = job_config(run)
    rows = SeededRows(m["vocab"], W, t["batch_per_worker"], t["seq"],
                      run.seed)
    dtype = getattr(torch, m["dtype"])
    params = moe_params(m, run.seed, run.device, dtype)
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
    counter = model.routed_rows
    n_moe = m["n_layers"] - m["n_dense_layers"]

    sess.fit(1)
    one_minus_b1 = 1.0 - torch.tensor(t["beta1"], dtype=torch.float32)
    grad = {p: n / float(one_minus_b1) for p, n in
            leaf_norms(sess.state.opt_state["m"]).items()}
    sess.fit(H - 1)
    counter.reset()
    held = HeldPairs(program_moe, *m["experts_held"], run.device)
    with held:
        sess.fit(H)
    # each counted layer call routed once more when its block was
    # recomputed in the backward pass
    layer_calls = n_moe * W * H
    if held.calls % layer_calls:
        raise RuntimeError(f"the router ran {held.calls} times over "
                           f"{layer_calls} layer calls")
    routed = int(counter.total.sum())
    want = int(held.count) // (held.calls // layer_calls)
    if routed != want:
        raise RuntimeError(f"routed_rows counted {routed} rows in the "
                           f"eager period; the router sent {want} "
                           f"(token, choice) pairs to held experts")
    run.info["eager_routed_rows"] = routed
    run.mark("a period step by step, and an eager one")
    # the checked period: a fresh start, captured and replayed as the
    # window's periods are
    restart(sess.state, m, run.seed, run.device, dtype)
    launched = grouped_gemm.launches_by_shape.copy()
    first = len(sess.history)
    sess.fit(H)
    per_period = grouped_gemm.launches_by_shape - launched
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
    for i, (path, _, _, _) in enumerate(moe_leaves(m)):
        p0 = draw_moe_leaf(m, run.seed, i, run.device, dtype).float()
        change[path] = math.sqrt(sum(
            float((w.float() - p0).norm()) ** 2 for w in leaves[path]))
        del p0
    del leaves
    run.mark("checked period read")

    tokens_per_step = W * t["batch_per_worker"] * t["seq"]
    first = len(sess.history)
    counter.reset()
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
        batch=t["batch_per_worker"], seq=t["seq"],
        expert_rows={"total": counter.total.sum().item(),
                     "peak": counter.peak.max().item(),
                     "worker_steps": steps * W,
                     "experts": n_moe * m["experts_held"][1]})

    if run.trace:
        before = counter.total.sum().item()
        run.profile(lambda: sess.fit(H))
        run.values["slice"] = {
            "steps": H, "groups": m["experts_held"][1],
            "routed_rows": counter.total.sum().item() - before,
            "layer_calls": layer_calls,
            "launches": [[layout, K, N, n] for (layout, K, N), n in
                         sorted(per_period.items())]}
    run.read_memory()
    del sess, model
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()

    run.values["train_check"] = {
        "m": m, "job": ref_job, "rows": lambda s: rows.tokens(2 * H + s),
        "first_rows": rows.tokens, "units": plan_units, "grad": grad,
        "losses": losses, "moment": moment, "change": change}
    run.mark("window and trace done, program freed")
    ref_first = moe_reference.train_reference(m, ref_job, run.seed,
                                              rows.tokens, run.device,
                                              steps=1)
    ref = moe_reference.train_reference(m, ref_job, run.seed,
                                        lambda s: rows.tokens(2 * H + s),
                                        run.device)
    run.compare_train(plan_units, grad, losses, moment, change,
                      ref_first, ref)
    run.mark("reference done")
    run.attempted = len(window_losses)
    run.failed = sum(not math.isfinite(x) for x in window_losses)
