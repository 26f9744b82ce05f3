"""DONATE: use of an argument after passing it to an in-place consumer.

Counterpart of ``repro.lint.rules.donation``.  PyTorch has no
``donate_argnums``; the port's form of the hazard is in-place
consumption.  ``Runner.run`` and its two paths update the state they are
given in place and return it, so after ``runner.run(state, n)`` the name
``state`` aliases the trained tensors: a read that expects the values
from before the call (a comparison, a second run from "the same" start)
gets the updated ones instead.  The safe shape is the rebind,
``state = runner.run(state, n)``, or a clone before the call.

Consumers are functions of the same module decorated with
``@consumes("argname", ...)`` (:mod:`repro_torch.lint.hotpath`), called
as ``name(...)`` or ``self.name(...)``.  Each scope is scanned linearly:
after a call consumes ``x``, a read of ``x`` before a rebind is flagged.
Loop bodies are scanned twice, so a consumption at the bottom of
iteration *n* catches the read at the top of iteration *n+1*; a
consumption inside ``return`` or ``raise`` leaves the scope and kills
nothing.  Where the callee cannot be resolved statically, the rule stays
silent, as the reference does.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .. import astutil
from ..engine import ModuleContext
from ..findings import Finding
from ..registry import Rule, register


def _consumers(ctx: ModuleContext
               ) -> dict[str, tuple[tuple[int, str], ...]]:
    """Call name (``f`` / ``self.f``) -> consumed (position, name) pairs,
    positions counted as the call site passes them."""
    out: dict[str, tuple[tuple[int, str], ...]] = {}
    for info in ctx.functions:
        for dec in info.node.decorator_list:
            if not (isinstance(dec, ast.Call)
                    and (ctx.resolve(dec.func) or "").split(".")[-1]
                    == "consumes"):
                continue
            names = [a.value for a in dec.args
                     if isinstance(a, ast.Constant)
                     and isinstance(a.value, str)]
            params = astutil.param_names(info.node)
            method = "." in info.qualname and params \
                and params[0] in ("self", "cls")
            if method:
                params = params[1:]
            key = f"self.{info.node.name}" if method else info.node.name
            out[key] = tuple((params.index(n) if n in params else -1, n)
                             for n in names)
    return out


def _consumed_args(call: ast.Call, spec) -> list[ast.Name]:
    out = []
    for pos, name in spec:
        arg = call.args[pos] if 0 <= pos < len(call.args) \
            else astutil.keyword(call, name)
        if isinstance(arg, ast.Name):
            out.append(arg)
    return out


@register
class DonationRule(Rule):
    name = "DONATE"
    summary = ("argument read after being passed to an in-place "
               "@consumes function (use-after-consume)")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        consumers = _consumers(ctx)
        if not consumers:
            return
        scopes: list[list[ast.stmt]] = [ctx.tree.body]
        scopes += [info.node.body for info in ctx.functions]
        for body in scopes:
            yield from self._scan_scope(body, consumers, ctx)

    def _scan_scope(self, body: list[ast.stmt], consumers,
                    ctx: ModuleContext) -> Iterable[Finding]:
        dead: dict[str, tuple[str, int]] = {}      # name -> (callee, line)
        flagged: set[int] = set()
        for stmt in astutil.iter_statements(body, unroll_loops=2):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            consumed: list[tuple[ast.Name, str]] = []
            for call in astutil.stmt_nodes(stmt):
                if not isinstance(call, ast.Call):
                    continue
                callee = astutil.dotted(call.func, {})
                if callee in consumers:
                    consumed += [(a, callee) for a in
                                 _consumed_args(call, consumers[callee])]
            # reads of names killed by an EARLIER statement: a statement's
            # own arguments never see their own kill, so the rebind idiom
            # stays clean and a second consumption of a dead name is not
            for node in astutil.stmt_nodes(stmt):
                if isinstance(node, ast.Name) \
                        and isinstance(node.ctx, ast.Load) \
                        and node.id in dead \
                        and id(node) not in flagged:
                    flagged.add(id(node))
                    callee, line = dead[node.id]
                    yield self.finding(
                        ctx, node,
                        f"`{node.id}` is read after being consumed by "
                        f"`{callee}` (line {line}), which updated it in "
                        "place — rebind the result (`x = fn(x, ...)`) or "
                        "clone before the call")
            if not isinstance(stmt, (ast.Return, ast.Raise)):
                for name_node, callee in consumed:
                    dead.setdefault(name_node.id,
                                    (callee, name_node.lineno))
            for rebound in astutil.assign_target_names(stmt):
                dead.pop(rebound, None)
