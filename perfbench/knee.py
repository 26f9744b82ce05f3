"""The highest arrival rate the serving engine sustains under an open-loop
mix: the knee that a mix's ``rate`` is set from (not run by the
benchmark's runs).

    python3 -m perfbench.knee --workload <cell> --seed <n> \\
        [--seconds 45] [--start 8] [--step 0.5]

One engine is built on the benchmark's weights; then, for each rate, the
open loop (:func:`perfbench.loops.open_loop.serve_open`) warms up and
runs one window, and every request left drains before the next rate.  A
rate is sustained when the requests that finish in the window number at
least 97% of those that arrive in it, and fewer than 64 (the slots) are
in a slot or queued at its end: by Little's law the requests in flight
are the rate times a request's time in the system, so under 64 the
slots keep up with the arrivals.  The rates go up from ``--start`` in
twice ``--step`` until one is not sustained, then the rate ``--step``
below that one is tried (from a ``--start`` not sustained, they go down
in ``--step``): the knee is the highest sustained rate on a grid of
``--step``.  Prints one JSON line a rate, then the knee.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from perfbench import bench  # noqa: E402
from perfbench.loops.open_loop import serve_open  # noqa: E402
from perfbench.weights import dense_params  # noqa: E402

SERVED, BACKLOG = 0.97, 64


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--start", type=float, default=8.0)
    ap.add_argument("--step", type=float, default=0.5)
    args = ap.parse_args()
    from repro_torch.serve import EngineConfig, ServeEngine

    run = bench.Run(args.workload, args.seed, args.seconds, False, t0=T0)
    model, m = run.model()
    mix, e = run.traffic, run.traffic["engine"]
    params = dense_params(m, args.seed, "cuda", getattr(torch, m["dtype"]))
    engine = ServeEngine(model, params, EngineConfig(
        max_batch=e["slots"], max_seq=e["max_seq"],
        decode_block=e["decode_block"], kv_backend="paged",
        page_size=e["page_size"]), device="cuda")

    def trial(rate: float) -> bool:
        t0 = time.perf_counter()
        got = serve_open(engine, mix, m["vocab"], args.seed, rate,
                         args.seconds)
        loop = got["loop"]
        loop.arriving = False
        while engine.has_work:
            loop.step()
        ok = got["completed"] >= SERVED * got["offered"] \
            and got["backlog"] < BACKLOG
        print(json.dumps({"rate": rate, "offered": got["offered"],
                          "completed": got["completed"],
                          "backlog": got["backlog"], "sustained": ok,
                          "seconds": time.perf_counter() - t0}), flush=True)
        return ok

    rate, best = args.start, None
    if trial(rate):
        while True:
            best, rate = rate, rate + 2 * args.step
            if not trial(rate):
                break
        if trial(rate - args.step):
            best = rate - args.step
    else:
        while best is None and rate > args.step:
            rate -= args.step
            if trial(rate):
                best = rate
    print(json.dumps({"knee": best, "device": torch.cuda.get_device_name()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
