"""Rule registry: rules self-register at import; the engine runs every
registered rule whose scope matches the module under analysis.

Copy of ``repro.lint.registry``."""

from __future__ import annotations

import ast
from typing import TYPE_CHECKING, Iterable

from . import astutil
from .findings import ERROR, Finding

if TYPE_CHECKING:                                     # pragma: no cover
    from .engine import ModuleContext

_RULES: dict[str, "Rule"] = {}


class Rule:
    """One hazard class.  Subclasses set ``name`` (the id used in
    pragmas/``--select``), ``severity``, a one-line ``summary``, and
    implement :meth:`check`."""

    name: str = ""
    severity: str = ERROR
    summary: str = ""

    def applies(self, ctx: "ModuleContext") -> bool:
        return True

    def check(self, ctx: "ModuleContext") -> Iterable[Finding]:
        raise NotImplementedError

    # ------------------------------------------------------------- helpers
    def finding(self, ctx: "ModuleContext", node: ast.AST, message: str,
                *, severity: str | None = None) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        fn = astutil.enclosing_function(node)
        context = ctx.qualname_of(fn) if fn is not None else ""
        text = ctx.lines[line - 1].strip() if line <= len(ctx.lines) else ""
        return Finding(rule=self.name, severity=severity or self.severity,
                       path=ctx.relpath, line=line, col=col + 1,
                       message=message, context=context, line_text=text)


def register(cls: type[Rule]) -> type[Rule]:
    if not cls.name:
        raise ValueError(f"rule {cls.__name__} has no name")
    if cls.name in _RULES:
        raise ValueError(f"duplicate rule name {cls.name}")
    _RULES[cls.name] = cls()
    return cls


def all_rules() -> dict[str, Rule]:
    from . import rules  # noqa: F401  (import side effect: registration)
    return dict(sorted(_RULES.items()))
