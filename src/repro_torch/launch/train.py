"""End-to-end training entry point — the :class:`repro_torch.api.Session` CLI.

Counterpart of ``repro.launch.train`` with the same flags plus
``--device``.  Trains any decoder of the port's registry (``--arch``:
granite-3-2b by default, qwen3-1.7b, phi4-mini-3.8b, qwen2.5-32b,
qwen3-moe-30b-a3b, mamba2-780m) with
any registered sync strategy on the synthetic Markov corpus: profile ->
schedule search -> bubble fill -> phase steps -> runner, all wired by
``Session(JobConfig(...)).fit(steps)``; this module only parses flags.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --smoke \\
        --algo dreamddp --workers 8 --steps 100 --period 5

``--device cpu`` trains on the CPU (the default is the GPU).
``--period-exec compiled`` runs each period as one CUDA graph replay (the
same period body without a graph on the CPU); ``--ckpt-dir`` saves a
checkpoint every 200 steps there and restarts from the last one after a
failure.  ``--async`` trains on the async two-tier runtime
(``repro_torch.hier``; ``--merge-rule``, ``--staleness-beta``) and
rounds ``--steps`` down to whole periods.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--algo", default="dreamddp",
                    help="any registered sync strategy (see repro_torch.api)")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--period", type=int, default=5, help="H")
    ap.add_argument("--batch-per-worker", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--bandwidth", type=float, default=1e9)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compress", default=None, choices=(None, "int8_ef"),
                    help="DEPRECATED: use --algo dreamddp-int8")
    ap.add_argument("--outer", action="store_true",
                    help="DiLoCo-style outer optimizer (beyond-paper; "
                         "DEPRECATED: register a strategy whose "
                         "sync_policy() returns OuterOptSync)")
    ap.add_argument("--track-divergence", action="store_true")
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="period-fused runner: one device synchronize per "
                         "H-step period with staged data (--no-fused = "
                         "per-step path)")
    ap.add_argument("--period-exec", default="pipeline",
                    choices=("pipeline", "compiled"),
                    help="fused period execution: 'pipeline' (the phase "
                         "steps queued back to back) or 'compiled' (one "
                         "CUDA graph replay per period)")
    ap.add_argument("--async", dest="async_mode",
                    action=argparse.BooleanOptionalAction, default=False,
                    help="asynchronous two-tier runtime (repro_torch.hier): "
                         "workers run periods on their own clocks and "
                         "push layer-wise deltas to a server tier — no "
                         "period-boundary barrier")
    ap.add_argument("--staleness-beta", type=float, default=0.9,
                    help="async merge: per-version staleness decay "
                         "(scale = beta ** min(tau, max_staleness))")
    ap.add_argument("--merge-rule", default="halos",
                    choices=("halos", "delayed-nesterov"),
                    help="async merge rule: HALoS staleness-aware "
                         "Nesterov momentum, or delayed-Nesterov "
                         "(buffered momentum every N merges)")
    ap.add_argument("--dry-run", action="store_true",
                    help="resolve the model and plan (and async config), "
                         "print them, and exit without training")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args(argv)

    from ..api import JobConfig, Session, available_strategies

    if args.algo not in available_strategies():
        ap.error(f"unknown --algo {args.algo!r}; registered: "
                 f"{', '.join(available_strategies())}")

    sess = Session(JobConfig(
        arch=args.arch, algo=args.algo, workers=args.workers,
        period=args.period, bandwidth=args.bandwidth,
        batch_per_worker=args.batch_per_worker, seq=args.seq,
        smoke=args.smoke, lr=args.lr, warmup_steps=10,
        decay_steps=max(args.steps, 100), compress=args.compress,
        outer=args.outer, track_divergence=args.track_divergence,
        fused_period=args.fused, period_exec=args.period_exec,
        ckpt_dir=args.ckpt_dir, async_mode=args.async_mode,
        staleness_beta=args.staleness_beta, merge_rule=args.merge_rule),
        device=args.device)

    model = sess.model
    mode = "async" if sess.use_async else \
        ("off" if not args.fused else args.period_exec)
    print(f"arch={args.arch} smoke={args.smoke} "
          f"params={model.param_count() / 1e6:.1f}M algo={args.algo} "
          f"W={args.workers} H={args.period} exec={mode} "
          f"device={sess.device}")
    plan = sess.plan
    print(f"plan: {plan.meta.get('partition_counts')} "
          f"extra_syncs={plan.meta.get('extra_syncs')} "
          f"fingerprint={plan.fingerprint()}")
    if sess.use_async:
        mc = sess.merge_config.resolve(args.workers)
        print(f"merge: rule={mc.rule} lr={mc.lr:.4g} "
              f"momentum={mc.momentum} beta={mc.staleness_beta} "
              f"max_staleness={mc.max_staleness}")
    if args.dry_run:
        print("dry run: configuration resolved, exiting before training")
        return 0

    steps = args.steps
    if sess.use_async and steps % args.period:
        steps = max(args.period, steps - steps % args.period)
        print(f"async fit advances whole periods: running {steps} steps")
    t0 = time.time()
    sess.fit(steps)
    dt = time.time() - t0
    losses = [h["loss"] for h in sess.history]
    data = sess.runner.data
    print(f"steps={len(sess.history)} loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (floor~{data.entropy_floor():.3f}) "
          f"[{dt:.1f}s, {dt / max(len(losses), 1) * 1e3:.0f} ms/step]")
    marked = [h for h in sess.history if "sync_s" in h]   # full periods
    if marked:
        print("ms/step by part: " + "  ".join(
            f"{k[:-2]}={statistics.fmean(h[k] for h in marked) * 1e3:.2f}"
            for k in ("grads_s", "optimizer_s", "sync_s")))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(sess.history, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
