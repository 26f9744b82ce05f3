"""Run one cell of the port's benchmark and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout: makes the weights and the inputs from the
seed on the card, warms up, measures for ``--seconds``, checks what the
timed path produced against the plain reference, and prints one JSON
line (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` the per-layer metrics and ``breakdown``; the numbers
the check compared come last, under ``checks``, and again as the last
lines on standard error).  Exits non-zero, printing no result, without
the cards the cell asks for, or if JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "perfbench_cache" / sub)
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from perfbench import bench  # noqa: E402


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else out.stderr.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cells = bench.load_json(ROOT / "BENCHMARK.json")["workloads"]
    chips = next((w["chips"] for w in cells if w["name"] == args.workload),
                 None)
    if chips is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = bench.Run(args.workload, args.seed, args.seconds,
                    bool(args.trace), t0=T0)
    out = run.go()
    out["device"]["power"] = power_limit()
    bad = bench.forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    for label, t in run.marks:
        print(f"at {t:.3f} s: {label}", file=sys.stderr)
    for name, value in run.info.items():
        print(f"not compared: {name} = {value!r}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
