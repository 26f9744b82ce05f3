"""Quickstart of the PyTorch port: the ``repro_torch.api.Session``
facade, end to end (the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

One object runs the whole DreamDDP pipeline — profile the layers,
search the partition (Algorithm 2), fill bubbles (§3.4), build one step
per phase, and train::

    sess = Session(JobConfig(arch="granite-3-2b", algo="dreamddp",
                             workers=8, period=5, bandwidth=1e9))
    sess.fit(40)

``algo`` names a pluggable :class:`repro_torch.api.SyncStrategy`; add
your own with :func:`repro_torch.api.register_strategy`.  Training runs
on the GPU unless ``--device cpu`` is given.
"""

import argparse

from repro_torch.api import JobConfig, Session, available_strategies
from repro_torch.core import simulate_period
from repro_torch.core.time_model import Partition
from repro_torch.device import resolve_device

W, H, STEPS = 8, 5, 40


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    sess = Session(JobConfig(arch="granite-3-2b", algo="dreamddp",
                             workers=W, period=H, bandwidth=1e9,
                             batch_per_worker=4, seq=64, lr=3e-3,
                             warmup_steps=5, decay_steps=400,
                             track_divergence=True), device=device)
    print(f"registered strategies: {', '.join(available_strategies())}")

    # 1. a model (the reduced granite config)
    model = sess.model
    print(f"model: {model.cfg.name}, {model.param_count() / 1e6:.2f}M "
          f"params, {len(model.unit_layout())} schedulable units")

    # 2. the layer profile for a 1 GB/s geo link
    profile = sess.profile()
    print(f"comm/compute ratio: {profile.comm_compute_ratio():.2f}")

    # 3. the strategy's schedule (Algorithm 2 + §3.4 bubble fill)
    plan = sess.plan
    print(f"partition (BP-order counts): {plan.meta['partition_counts']}")
    print(f"supplementary syncs/period:  {plan.meta['extra_syncs']}")
    for h in range(H):
        print(f"  phase {h}: sync units {plan.units_for_phase(h)}")

    # 4. predicted period timeline vs baselines
    part = Partition(tuple(plan.meta["partition_counts"]))
    t = sum(x.iteration_time for x in simulate_period(profile, part)) / H
    ssgd = profile.t_fp_total + profile.t_bp_total + profile.t_comm_total
    print(f"predicted iteration time: {t * 1e3:.1f} ms "
          f"(vs S-SGD {1e3 * ssgd:.1f} ms)")

    # 5. train for real
    sess.fit(STEPS)
    h0, h1 = sess.history[0], sess.history[-1]
    print(f"loss {h0['loss']:.3f} -> {h1['loss']:.3f}; "
          f"divergence {h1['divergence']:.2e}")


if __name__ == "__main__":
    main()
