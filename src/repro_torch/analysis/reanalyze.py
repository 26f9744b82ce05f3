"""Re-sum executed costs of existing dry-run artifacts from their stored
per-op tables, without tracing again (``repro.analysis.reanalyze``
counterpart).

    PYTHONPATH=src python -m repro_torch.analysis.reanalyze [--dir artifacts/dryrun]
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os

from .collectives import CollectiveOp, CollectiveSummary
from .roofline import roofline_from_artifact

__all__ = ["reanalyze", "costs_from_table"]


def costs_from_table(table: dict) -> tuple[dict, dict]:
    """(``cost_analysis``, ``collectives``) re-summed from a per-op
    table."""
    rows = table["ops"].values()
    cost = {"flops": sum(r[1] for r in rows),
            "bytes accessed": sum(r[2] for r in rows),
            "n_dots": sum(r[3] for r in rows),
            "unknown_loops": table["unknown_loops"]}
    summary = CollectiveSummary([CollectiveOp(kind, nbytes, group)
                                 for kind, nbytes, group, n
                                 in table["collectives"]
                                 for _ in range(n)])
    return cost, summary.to_dict()


def reanalyze(path: str) -> dict:
    with open(path) as f:
        art = json.load(f)
    with gzip.open(path[:-5] + ".ops.json.gz", "rt") as f:
        table = json.load(f)
    art["cost_analysis"], art["collectives"] = costs_from_table(table)
    art["roofline_h100"] = roofline_from_artifact(art).to_dict()
    with open(path, "w") as f:
        json.dump(art, f, indent=1)
    return art


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun")
    args = ap.parse_args(argv)
    n = 0
    for path in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        if not os.path.exists(path[:-5] + ".ops.json.gz"):
            continue
        art = reanalyze(path)
        c = art["cost_analysis"]
        print(f"{os.path.basename(path):60s} flops={c['flops']:.3e} "
              f"bytes={c['bytes accessed']:.3e} "
              f"wire={art['collectives']['total_wire_bytes']:.3e}")
        n += 1
    print(f"reanalyzed {n} artifacts")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
