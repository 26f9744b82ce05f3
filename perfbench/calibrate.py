"""The readings the check's limits are set from, on the card at the
cell's own sizes (not run by the benchmark's runs).

    python3 -m perfbench.calibrate --workload <cell> --seeds 11 12 13 \\
        [--control 11 12 13] [--seconds 8]

For each seed a short run of the cell (set-up, a short window, the
check) gives the program's reading of every number (the lower end).  For
the seeds under ``--control`` the same numbers are read for the control,
the reference computed with float8 e4m3 operands in place of the
program, and, in a training cell, for the reference with each planted
fault (half of each worker's rows; the averages left out); a state left
unchanged reads 1 on the gradient and the change by their measure.
Prints one JSON line a seed.
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

from perfbench import bench, reference  # noqa: E402
from perfbench.loops.closed_loop import widest_gap  # noqa: E402


def leaf_gaps(got: dict, want: dict) -> dict:
    med = sorted(want.values())[len(want) // 2]
    return {p: abs(got[p] - w) / max(w, med) for p, w in want.items()}


def train_readings(run) -> dict:
    """Every training number of the program, of the control and of each
    planted fault, against the reference; per leaf and per step too."""
    c = run.values.pop("train_check")
    sides = {"ref": {}, "control_fp8": {"quant": "fp8"},
             "half_batch": {"fault": "half_batch"},
             "no_sync": {"fault": "no_sync"}}
    got = {}
    for name, kw in sides.items():
        one = reference.train_reference(c["m"], c["job"], run.seed,
                                        c["first_rows"], run.device, steps=1,
                                        **kw)
        got[name] = reference.train_reference(c["m"], c["job"], run.seed,
                                              c["rows"], run.device, **kw)
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
                            "moment": leaf_gaps(g["moment"], ref["moment"]),
                            "change": leaf_gaps(g["change"], ref["change"])}
                     for name, g in got.items()}
    out["detail"]["ref"] = {"losses": ref["losses"]}
    return out


def serve_readings(run) -> dict:
    """The program's widest gap and the control's: at each position of
    the same sample, the gap of the token float8 puts first."""
    c = run.values.pop("serve_check")
    ctl = reference.served_logits(c["m"], run.seed, run.device, c["seqs"],
                                  quant="fp8")
    picks = [lg.argmax(1).tolist() for lg in ctl]
    return {
        "program": {n: v for n, v, _ in run.checks},
        "control_fp8": {"served_logit_gap": widest_gap(c["logits"], picks)},
        "checked_tokens": run.values["checked_tokens"],
        "control_flips": sum(sum(a != b for a, b in zip(p, t, strict=True))
                             for p, t in zip(picks, c["tokens"],
                                             strict=True)),
        "margin_min": min(float((t[:, 0] - t[:, 1]).min()) for t in
                          (lg.topk(2, 1).values for lg in c["logits"])),
    }


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
        loop = run.traffic["loop"]
        run.go()
        out = {"workload": args.workload, "seed": seed}
        if seed in args.control:
            out.update(train_readings(run) if loop == "train"
                       else serve_readings(run))
        else:
            out["program"] = {n: v for n, v, _ in run.checks}
        out["failed"] = run.failed
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
