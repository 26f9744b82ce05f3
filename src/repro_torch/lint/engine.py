"""Analysis engine: file discovery, parsing, pragma handling, rule
dispatch.  Pure stdlib — importing this package never imports torch or
jax, so the linter runs anywhere (CI lint job, pre-commit, bare
containers).

Copy of ``repro.lint.engine``: the same pragma syntax and the same
reports; module names are guessed under ``repro_torch``.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Sequence

from . import astutil
from .findings import ERROR, Finding
from .hotpath import EXTRA_HOT_PATHS
from .registry import all_rules

__all__ = ["ModuleContext", "FunctionInfo", "lint_text", "lint_paths",
           "iter_py_files", "pragma_map"]

# `# repro-lint: disable=RULE-A,RULE-B -- justification`
# `# repro-lint: disable` (all rules) — justification text after `--`
# is free-form and encouraged.
_PRAGMA = re.compile(
    r"#\s*repro-lint:\s*disable(?:=(?P<rules>[A-Za-z0-9_\-, ]+))?")
_ALL = "*"


@dataclass(frozen=True)
class FunctionInfo:
    node: ast.AST                  # FunctionDef | AsyncFunctionDef
    qualname: str
    is_hot: bool
    decorators: tuple[str, ...]    # resolved dotted names ('' unresolved)


@dataclass
class ModuleContext:
    path: Path
    relpath: str                   # posix style; what findings report
    module: str                    # dotted module guess ("" if unknown)
    source: str
    lines: list[str]
    tree: ast.Module
    aliases: dict[str, str]
    functions: list[FunctionInfo] = field(default_factory=list)

    def resolve(self, node: ast.AST) -> str | None:
        """Dotted path of a name/attribute chain through import aliases
        (``np.asarray`` -> ``numpy.asarray``)."""
        return astutil.dotted(node, self.aliases)

    def qualname_of(self, fn_node: ast.AST) -> str:
        for info in self.functions:
            if info.node is fn_node:
                return info.qualname
        return getattr(fn_node, "name", "<lambda>")

    def function_info(self, fn_node: ast.AST) -> FunctionInfo | None:
        for info in self.functions:
            if info.node is fn_node:
                return info
        return None

    def hot_functions(self) -> list[FunctionInfo]:
        return [f for f in self.functions if f.is_hot]

    def calls(self, *dotted_names: str) -> Iterable[ast.Call]:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call) \
                    and self.resolve(node.func) in dotted_names:
                yield node


def _collect_functions(ctx: ModuleContext) -> None:
    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                decs = tuple(ctx.resolve(d) or "" for d in
                             child.decorator_list)
                hot = any(d == "hot_path" or d.endswith(".hot_path")
                          for d in decs)
                hot = hot or f"{ctx.module}:{qual}" in EXTRA_HOT_PATHS
                ctx.functions.append(FunctionInfo(
                    node=child, qualname=qual, is_hot=hot, decorators=decs))
                visit(child, f"{qual}.")
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.")
            else:
                visit(child, prefix)

    visit(ctx.tree, "")


def pragma_map(lines: list[str]) -> dict[int, set[str]]:
    """Line number -> suppressed rule names ('*' = all).  A pragma on a
    code line covers that line; a standalone comment pragma covers the
    next code line (skipping continuation comments and blanks, so a
    multi-line justification comment still lands on the statement)."""
    out: dict[int, set[str]] = {}
    for i, line in enumerate(lines, start=1):
        m = _PRAGMA.search(line)
        if not m:
            continue
        rules = m.group("rules")
        if rules is not None:
            # drop the free-form `-- justification` tail (rule names use
            # single hyphens only)
            rules = rules.split("--")[0]
        names = ({_ALL} if rules is None else
                 {r.strip().upper() for r in rules.split(",") if r.strip()})
        target = i
        if line.strip().startswith("#"):
            target = i + 1
            while target <= len(lines) and (
                    not lines[target - 1].strip()
                    or lines[target - 1].strip().startswith("#")):
                target += 1
        out.setdefault(target, set()).update(names)
    return out


def _module_guess(relpath: str) -> str:
    parts = Path(relpath).with_suffix("").parts
    if "src" in parts:
        parts = parts[parts.index("src") + 1:]
    elif "repro_torch" in parts:
        parts = parts[parts.index("repro_torch"):]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def build_context(source: str, path: str | Path) -> ModuleContext:
    p = Path(path)
    relpath = p.as_posix()
    tree = ast.parse(source, filename=relpath)
    astutil.attach_parents(tree)
    ctx = ModuleContext(
        path=p, relpath=relpath, module=_module_guess(relpath),
        source=source, lines=source.splitlines(),
        tree=tree, aliases=astutil.collect_aliases(tree))
    _collect_functions(ctx)
    return ctx


def _run_rules(ctx: ModuleContext, select: Sequence[str] | None,
               ignore: Sequence[str] | None) -> list[Finding]:
    findings: list[Finding] = []
    for name, rule in all_rules().items():
        if select and name not in select:
            continue
        if ignore and name in ignore:
            continue
        if rule.applies(ctx):
            findings.extend(rule.check(ctx))
    pragmas = pragma_map(ctx.lines)
    kept = [f for f in findings
            if not (pragmas.get(f.line, set()) & {_ALL, f.rule})]
    return sorted(kept, key=lambda f: (f.path, f.line, f.col, f.rule))


def lint_text(source: str, path: str | Path = "snippet.py", *,
              select: Sequence[str] | None = None,
              ignore: Sequence[str] | None = None) -> list[Finding]:
    """Analyze one module given as text (the test-suite entry point).
    ``path`` matters: path-scoped rules (KERNEL, SIM-DETERMINISM) key
    off it."""
    try:
        ctx = build_context(source, path)
    except SyntaxError as e:
        return [Finding(rule="PARSE", severity=ERROR,
                        path=Path(path).as_posix(), line=e.lineno or 1,
                        col=(e.offset or 0) + 1,
                        message=f"syntax error: {e.msg}")]
    return _run_rules(ctx, select, ignore)


def iter_py_files(paths: Iterable[str | Path]) -> list[Path]:
    out: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(f for f in sorted(p.rglob("*.py"))
                       if "__pycache__" not in f.parts)
        elif p.suffix == ".py":
            out.append(p)
    return out


def lint_paths(paths: Iterable[str | Path], *,
               select: Sequence[str] | None = None,
               ignore: Sequence[str] | None = None) -> list[Finding]:
    """Analyze files/directories; returns pragma-filtered findings
    (baseline filtering is the CLI's job)."""
    findings: list[Finding] = []
    for f in iter_py_files(paths):
        findings.extend(lint_text(f.read_text(), f, select=select,
                                  ignore=ignore))
    return findings
