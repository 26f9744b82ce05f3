"""AST conveniences shared by the rules: parent links, import-alias
resolution, dotted-name rendering, and lightweight value provenance.

Everything here is best-effort static analysis: when a construct can't
be resolved (dynamic attribute, re-exported name, computed call) the
helpers return ``None`` and rules stay silent rather than guess.

Copy of ``repro.lint.astutil`` without the helpers only the JAX rules
use; the examples speak of torch.
"""

from __future__ import annotations

import ast
from typing import Iterator

_PARENT = "_repro_lint_parent"


def attach_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            setattr(child, _PARENT, node)


def parent(node: ast.AST) -> ast.AST | None:
    return getattr(node, _PARENT, None)


def ancestors(node: ast.AST) -> Iterator[ast.AST]:
    cur = parent(node)
    while cur is not None:
        yield cur
        cur = parent(cur)


def enclosing_function(node: ast.AST) -> ast.AST | None:
    for anc in ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None


def enclosing_loop(node: ast.AST, *, stop: ast.AST | None = None
                   ) -> ast.AST | None:
    """Nearest For/While statement ancestor, not crossing ``stop`` (nor
    any function boundary — a loop outside the enclosing function does
    not make a call site "inside a loop")."""
    for anc in ancestors(node):
        if anc is stop or isinstance(anc, (ast.FunctionDef,
                                           ast.AsyncFunctionDef,
                                           ast.Lambda)):
            return None
        if isinstance(anc, (ast.For, ast.While)):
            return anc
    return None


def collect_aliases(tree: ast.AST) -> dict[str, str]:
    """Local name -> dotted module path, from every import statement.

    ``import torch.nn.functional as F`` -> ``{"F": "torch.nn.functional"}``;
    ``from torch.utils.checkpoint import checkpoint`` ->
    ``{"checkpoint": "torch.utils.checkpoint.checkpoint"}``;
    ``import numpy as np`` -> ``{"np": "numpy"}``;
    relative imports are left as their bare names (never a hazard
    target here).
    """
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    root = a.name.split(".")[0]
                    aliases[root] = root
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def dotted(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """Render an attribute chain as a dotted path with the root name
    expanded through the import aliases; ``None`` if the chain bottoms
    out in anything but a plain name."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(aliases.get(node.id, node.id))
        return ".".join(reversed(parts))
    return None


def keyword(call: ast.Call, name: str) -> ast.AST | None:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def param_names(fn: ast.FunctionDef | ast.AsyncFunctionDef | ast.Lambda
                ) -> list[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def iter_statements(body: list[ast.stmt], *, unroll_loops: int = 1
                    ) -> Iterator[ast.stmt]:
    """Flatten a statement list in source order, descending into
    compound statements.  ``unroll_loops=2`` yields each loop body
    twice, which lets linear-scan rules catch wrap-around hazards
    (a key consumed every iteration, a read at the top of iteration
    *n+1* of a buffer donated at the bottom of iteration *n*)."""
    for stmt in body:
        yield stmt
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            for _ in range(unroll_loops):
                yield from iter_statements(stmt.body,
                                           unroll_loops=unroll_loops)
            yield from iter_statements(stmt.orelse,
                                       unroll_loops=unroll_loops)
        elif isinstance(stmt, ast.If):
            yield from iter_statements(stmt.body, unroll_loops=unroll_loops)
            yield from iter_statements(stmt.orelse,
                                       unroll_loops=unroll_loops)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            yield from iter_statements(stmt.body, unroll_loops=unroll_loops)
        elif isinstance(stmt, ast.Try):
            for blk in (stmt.body, stmt.orelse, stmt.finalbody):
                yield from iter_statements(blk, unroll_loops=unroll_loops)
            for handler in stmt.handlers:
                yield from iter_statements(handler.body,
                                           unroll_loops=unroll_loops)


def stmt_nodes(stmt: ast.stmt) -> Iterator[ast.AST]:
    """AST nodes belonging to one statement, excluding nested statement
    bodies — compound-statement children are visited when
    :func:`iter_statements` yields them, so linear-scan rules that pair
    the two don't double-count."""
    if isinstance(stmt, (ast.If, ast.While)):
        roots: list[ast.AST] = [stmt.test]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        roots = [stmt.target, stmt.iter]
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        roots = [i.context_expr for i in stmt.items]
        roots += [i.optional_vars for i in stmt.items if i.optional_vars]
    elif isinstance(stmt, ast.Try):
        roots = []
    else:
        roots = [stmt]
    for r in roots:
        yield from ast.walk(r)


def walk_no_nested_functions(node: ast.AST) -> Iterator[ast.AST]:
    """Walk ``node`` without descending into nested function/class
    definitions (their scopes are analyzed separately)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        cur = stack.pop()
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda, ast.ClassDef)):
            continue
        yield cur
        stack.extend(ast.iter_child_nodes(cur))


def assign_target_names(stmt: ast.stmt) -> list[str]:
    """Plain names (re)bound by an assignment-like statement."""
    targets: list[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        targets = [stmt.target]
    out: list[str] = []

    def add(t: ast.AST) -> None:
        if isinstance(t, ast.Name):
            out.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for elt in t.elts:
                add(elt)
        elif isinstance(t, ast.Starred):
            add(t.value)

    for t in targets:
        add(t)
    return out
