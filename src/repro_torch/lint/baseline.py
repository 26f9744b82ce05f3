"""Baseline I/O: grandfathered findings that don't gate CI.

The baseline is a committed JSON file of finding fingerprints
(rule + path + enclosing function + normalized source line — stable
across unrelated line-number churn).  ``python -m repro_torch.lint
--write-baseline`` regenerates it; a finding not in the baseline fails
the run.  Duplicate fingerprints (two identical lines in one function)
are handled by count: the baseline absorbs as many occurrences as it
recorded, no more.

Copy of ``repro.lint.baseline``: the same format (version 1).
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

from .findings import Finding

VERSION = 1


def load(path: str | Path) -> Counter:
    """Fingerprint -> grandfathered occurrence count (empty if the file
    doesn't exist — an absent baseline means 'everything gates')."""
    p = Path(path)
    if not p.exists():
        return Counter()
    data = json.loads(p.read_text())
    if data.get("version") != VERSION:
        raise ValueError(f"unsupported baseline version in {p}: "
                         f"{data.get('version')!r}")
    return Counter(f["fingerprint"] for f in data.get("findings", []))


def save(path: str | Path, findings: list[Finding]) -> None:
    entries = [{
        "fingerprint": f.fingerprint(),
        "rule": f.rule,
        "path": f.path,
        "context": f.context,
        "line_text": f.line_text,
    } for f in findings]
    payload = {"version": VERSION, "findings": entries}
    Path(path).write_text(json.dumps(payload, indent=2,
                                     sort_keys=True) + "\n")


def partition(findings: list[Finding], grandfathered: Counter
              ) -> tuple[list[Finding], list[Finding]]:
    """Split findings into (new, baselined), consuming baseline counts."""
    budget = Counter(grandfathered)
    new: list[Finding] = []
    old: list[Finding] = []
    for f in findings:
        fp = f.fingerprint()
        if budget[fp] > 0:
            budget[fp] -= 1
            old.append(f)
        else:
            new.append(f)
    return new, old
