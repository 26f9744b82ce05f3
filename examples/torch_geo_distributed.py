"""Geo-distributed scenario with the PyTorch port: how the schedule
adapts to the WAN link (the counterpart of
``examples/geo_distributed.py``).

Sweeps the inter-datacenter bandwidth from 10 MB/s to 20 GB/s for the
full granite-3-2b config and shows the Algorithm-2 partition, the phase
timelines, and DreamDDP's speedup over S-SGD / ASC-WFBP / FLSGD at each
point (the paper's Figs 1-2 + Table 1 story).  One
:class:`repro_torch.api.Session` and five ``replan()`` calls; the
analysis builds no training state, so the device only names where a
``fit`` would run.

    PYTHONPATH=src python examples/torch_geo_distributed.py
    PYTHONPATH=src python examples/torch_geo_distributed.py --device cpu
"""

import argparse

from repro_torch.api import JobConfig, Session
from repro_torch.core import (ascwfbp_iteration_time, flsgd_period_time,
                              simulate_period, ssgd_iteration_time)
from repro_torch.core.time_model import Partition
from repro_torch.device import resolve_device

H, W = 5, 32


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args()
    sess = Session(JobConfig(arch="granite-3-2b", algo="dreamddp",
                             smoke=False, workers=W, period=H,
                             batch_per_worker=8, seq=4096, bandwidth=1e7,
                             latency=1e-3,
                             chips_per_worker=256),   # one worker = one pod
                   device=resolve_device(args.device))

    print(f"{'bandwidth':>12} {'ratio':>7} {'partition':>22} "
          f"{'dream ms':>9} {'ssgd ms':>9} {'ascwfbp':>9} {'flsgd':>9} "
          f"{'S1':>6} {'S2':>6}")
    for bw in (1e7, 1e8, 1e9, 5e9, 2e10):
        plan = sess.replan(bandwidth=bw)
        prof = sess.profile()
        part = Partition(tuple(plan.meta["partition_counts"]))
        n = plan.n_units
        fills = [[n - 1 - u for u in f] for f in plan.fill_units]
        dream = sum(t.iteration_time
                    for t in simulate_period(prof, part, fills)) / H
        ssgd = ssgd_iteration_time(prof)
        asc = ascwfbp_iteration_time(prof)
        fl = flsgd_period_time(prof, H) / H
        counts = plan.meta["partition_counts"]
        print(f"{bw:12.0e} {prof.comm_compute_ratio():7.2f} "
              f"{str(counts):>22} {dream * 1e3:9.1f} {ssgd * 1e3:9.1f} "
              f"{asc * 1e3:9.1f} {fl * 1e3:9.1f} {asc / dream:6.2f} "
              f"{fl / dream:6.2f}")

    print("\nS1 = speedup vs ASC-WFBP, S2 = vs FLSGD (paper Table 1 ranges: "
          "1.73-5.22x and 1.16-1.50x)")


if __name__ == "__main__":
    main()
