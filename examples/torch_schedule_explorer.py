"""ASCII timeline explorer for DreamDDP schedules, with the PyTorch
port's planner (the counterpart of ``examples/schedule_explorer.py``).

Renders one synchronization period: per phase, the BP lane and the comm
lane, with the §3.4 bubble fills marked `+`.  The planner runs on the
host; ``--device`` is checked as every entry point of the port checks it
(the GPU unless ``cpu`` is given) and nothing is placed on it.

    PYTHONPATH=src python examples/torch_schedule_explorer.py \\
        --arch qwen3-1.7b --bandwidth 1e9 --H 5 --device cpu
"""

import argparse

from repro_torch.configs import get_arch
from repro_torch.core import HardwareSpec, analytic_profile, build_plan
from repro_torch.core.time_model import Partition, simulate_phase
from repro_torch.device import resolve_device

WIDTH = 78


def render(profile, plan):
    part = Partition(tuple(plan.meta["partition_counts"]))
    n = plan.n_units
    total = None
    for h, (s, e) in enumerate(part.bp_intervals()):
        base = set(range(s, e))
        fills = {n - 1 - u for u in plan.fill_units[h]}
        tl = simulate_phase(profile, sorted(base | fills))
        if total is None:
            total = max(tl.iteration_time, 1e-12)
        scale = WIDTH / total
        bp_end = int(tl.bp_end * scale)
        lane_bp = "#" * bp_end + "." * (WIDTH - bp_end)
        lane_cm = [" "] * WIDTH
        for i, t0 in tl.comm_start.items():
            t1 = tl.comm_done[i]
            a, b = int(t0 * scale), max(int(t1 * scale), int(t0 * scale) + 1)
            ch = "+" if i in fills else "="
            for x in range(a, min(b, WIDTH)):
                lane_cm[x] = ch
        units = sorted(n - 1 - i for i in base)
        print(f"phase {h}: sync units {units} "
              f"(+{len(fills)} fills), iter {tl.iteration_time * 1e3:.1f} ms,"
              f" exposed comm {tl.exposed_comm * 1e3:.1f} ms")
        print("  BP  |" + lane_bp + "|")
        print("  COMM|" + "".join(lane_cm) + "|")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--bandwidth", type=float, default=1e9)
    ap.add_argument("--H", type=int, default=5)
    ap.add_argument("--workers", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args()
    resolve_device(args.device)

    model = get_arch(args.arch).make_model()
    hw = HardwareSpec(bandwidth=args.bandwidth, n_workers=args.workers,
                      latency=1e-3)
    prof = analytic_profile(model.layer_costs(args.batch, args.seq), hw)
    plan = build_plan("dreamddp", prof, args.H)
    print(f"{args.arch}: {plan.n_units} units, H={args.H}, "
          f"bw={args.bandwidth:.0e} B/s, comm/compute "
          f"{prof.comm_compute_ratio():.2f}")
    render(prof, plan)


if __name__ == "__main__":
    main()
