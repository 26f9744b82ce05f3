"""The readings the MoE training cell's limits are set from, on the card at
the cell's own sizes (not run by the benchmark's runs); as
:mod:`perfbench.calibrate` reads a dense training cell's.

    python3 -m perfbench.calibrate_moe --workload <cell> --seeds 11 12 \\
        [--control 11 12] [--seconds 8]

For each seed a short run of the cell gives the program's reading of
every number (the lower end).  For the seeds under ``--control`` the
same numbers are read for the control (the MoE reference with float8
e4m3 operands in every product, in the program's place) and for the
reference with each planted fault (half of each worker's rows; the
averages left out).  Prints one JSON line a seed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from perfbench import bench, moe_reference  # noqa: E402
from perfbench.calibrate import leaf_gaps  # noqa: E402


def train_readings(run) -> dict:
    """Every training number of the program, of the control and of each
    planted fault, against the reference; per leaf and per step too."""
    c = run.values.pop("train_check")
    sides = {"ref": {}, "control_fp8": {"quant": "fp8"},
             "half_batch": {"fault": "half_batch"},
             "no_sync": {"fault": "no_sync"}}
    got = {}
    for name, kw in sides.items():
        one = moe_reference.train_reference(c["m"], c["job"], run.seed,
                                            c["first_rows"], run.device,
                                            steps=1, **kw)
        got[name] = moe_reference.train_reference(c["m"], c["job"],
                                                  run.seed, c["rows"],
                                                  run.device, **kw)
        got[name]["grad"] = one["grad_norms"]
    ref = got.pop("ref")
    first = {"grad_norms": ref["grad"]}
    got["program"] = {"grad": c["grad"], "losses": c["losses"],
                      "moment": c["moment"], "change": c["change"],
                      "phase_units": c["units"]}
    out = {name: bench.train_numbers(g["phase_units"], g["grad"],
                                     g["losses"], g["moment"], g["change"],
                                     first, ref)
           for name, g in got.items()}
    out["detail"] = {name: {"losses": g["losses"],
                            "grad": leaf_gaps(g["grad"], ref["grad"]),
                            "change": leaf_gaps(g["change"], ref["change"])}
                     for name, g in got.items()}
    out["detail"]["ref"] = {"losses": ref["losses"]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args()
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = bench.Run(args.workload, seed, args.seconds, False, t0=t0)
        run.go()
        out = {"workload": args.workload, "seed": seed}
        if seed in args.control:
            out.update(train_readings(run))
        else:
            out["program"] = {n: v for n, v, _ in run.checks}
        out["failed"] = run.failed
        out["info"] = run.info
        out["memory_peak_bytes"] = run.memory_peak
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
