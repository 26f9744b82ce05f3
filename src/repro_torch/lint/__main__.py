"""CLI: ``python -m repro_torch.lint [paths...]``.

Exit codes: 0 — clean (or every finding baselined / warning-only),
1 — new error findings (new warnings too, under ``--strict``),
2 — usage or internal error.  The reference's CLI (``repro.lint``),
with the port's default path and baseline.
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter
from pathlib import Path

from . import baseline as baseline_io
from . import report
from .engine import lint_paths
from .findings import ERROR

DEFAULT_BASELINE = ".repro-torch-lint-baseline.json"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="PyTorch/CUDA-aware static analysis: host-sync, "
                    "capture/compile, use-after-consume, RNG-stream, "
                    "kernel-fallback and sim-determinism hazard rules "
                    "(see src/repro_torch/lint/README.md)")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories (default: src/repro_torch)")
    ap.add_argument("--format", choices=("human", "json"),
                    default="human")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: {DEFAULT_BASELINE} "
                         "next to the first path's repo root, if present)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the current findings as the new baseline "
                         "and exit 0")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule names to run")
    ap.add_argument("--ignore", default=None,
                    help="comma-separated rule names to skip")
    ap.add_argument("--strict", action="store_true",
                    help="warnings also gate (exit 1)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        print(report.render_rule_list())
        return 0

    select = [s.strip().upper() for s in args.select.split(",")] \
        if args.select else None
    ignore = [s.strip().upper() for s in args.ignore.split(",")] \
        if args.ignore else None

    findings = lint_paths(args.paths, select=select, ignore=ignore)

    baseline_path = args.baseline
    if baseline_path is None and Path(DEFAULT_BASELINE).exists():
        baseline_path = DEFAULT_BASELINE

    if args.write_baseline:
        out = baseline_path or DEFAULT_BASELINE
        baseline_io.save(out, findings)
        print(f"wrote {len(findings)} finding(s) to {out}")
        return 0

    grandfathered = (baseline_io.load(baseline_path) if baseline_path
                     else Counter())
    new, old = baseline_io.partition(findings, grandfathered)

    out = report.render_human(new, old) if args.format == "human" \
        else report.render_json(new, old)
    print(out)

    gating = [f for f in new
              if f.severity == ERROR or args.strict]
    return 1 if gating else 0


if __name__ == "__main__":
    sys.exit(main())
