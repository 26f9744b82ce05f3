"""Human and JSON rendering of a lint run (copy of ``repro.lint.report``:
the same keys)."""

from __future__ import annotations

import json

from .findings import ERROR, Finding
from .registry import all_rules


def summarize(new: list[Finding], baselined: list[Finding]) -> dict:
    return {
        "new": len(new),
        "errors": sum(1 for f in new if f.severity == ERROR),
        "warnings": sum(1 for f in new if f.severity != ERROR),
        "baselined": len(baselined),
        "rules": sorted({f.rule for f in new}),
    }


def render_human(new: list[Finding], baselined: list[Finding]) -> str:
    lines = [f.render() for f in new]
    s = summarize(new, baselined)
    tail = (f"{s['new']} finding(s): {s['errors']} error(s), "
            f"{s['warnings']} warning(s)")
    if baselined:
        tail += f"; {s['baselined']} baselined finding(s) not shown"
    if not new:
        tail = "clean" if not baselined else \
            f"clean ({s['baselined']} baselined finding(s) not shown)"
    lines.append(tail)
    return "\n".join(lines)


def render_json(new: list[Finding], baselined: list[Finding]) -> str:
    payload = {
        "version": 1,
        "findings": [f.to_json() for f in new],
        "baselined": [f.to_json() for f in baselined],
        "summary": summarize(new, baselined),
    }
    return json.dumps(payload, indent=2)


def render_rule_list() -> str:
    lines = []
    for name, rule in all_rules().items():
        lines.append(f"{name:18s} [{rule.severity}] {rule.summary}")
    return "\n".join(lines)
