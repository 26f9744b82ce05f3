"""SIM-DETERMINISM: nondeterminism sources in the simulator/scheduler.

Copy of ``repro.lint.rules.sim_determinism`` (the same checks and
messages); the scopes are the port's own paths.

SimNet traces are canonical JSON pinned by conformance tests, and the
schedule solver's output is compared against a brute-force optimum —
both must be bit-stable across runs and Python versions.  Two hazard
classes are rejected inside ``src/repro_torch/sim/``,
``src/repro_torch/core/schedule.py`` and ``src/repro_torch/hier/``:

* **wall-clock / ambient randomness** — ``time.time`` /
  ``perf_counter`` / ``datetime.now`` / stdlib ``random.*`` leak host
  timing or unseeded state into simulated time;
* **unordered iteration feeding output** — iterating a ``set`` (or
  materializing one with ``list()``/``tuple()``) makes trace/schedule
  ordering hash-dependent.  Order-insensitive consumers (``sorted``,
  ``min``/``max``/``sum``/``len``/``any``/``all``/``set``) are exempt;
  everything else must go through ``sorted(...)``.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .. import astutil
from ..engine import ModuleContext
from ..findings import Finding
from ..registry import Rule, register

_SCOPES = ("repro_torch/sim/", "repro_torch/core/schedule.py",
           "repro_torch/hier/")

_WALLCLOCK = {
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "time.process_time", "datetime.datetime.now",
    "datetime.datetime.utcnow", "datetime.date.today", "uuid.uuid4",
}
_ORDER_FREE = {"sorted", "set", "frozenset", "sum", "min", "max", "len",
               "any", "all"}
_MATERIALIZERS = {"list", "tuple"}
_SET_METHODS = {"union", "intersection", "difference",
                "symmetric_difference", "copy"}


def _is_set_typed(node: ast.AST, set_names: set[str],
                  ctx: ModuleContext) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Name):
        return node.id in set_names
    if isinstance(node, ast.Call):
        dot = ctx.resolve(node.func)
        if dot in ("set", "frozenset"):
            return True
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _SET_METHODS:
            return _is_set_typed(node.func.value, set_names, ctx)
        return False
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.Sub, ast.BitOr, ast.BitAnd, ast.BitXor)):
        return _is_set_typed(node.left, set_names, ctx) \
            or _is_set_typed(node.right, set_names, ctx)
    if isinstance(node, ast.Attribute):
        return astutil.dotted(node, {}) in set_names
    return False


@register
class SimDeterminismRule(Rule):
    name = "SIM-DETERMINISM"
    summary = ("wall-clock reads and unordered set iteration inside the "
               "simulator / schedule solver")

    def applies(self, ctx: ModuleContext) -> bool:
        return any(s in ctx.relpath for s in _SCOPES)

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        set_names = self._set_typed_names(ctx)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                dot = ctx.resolve(node.func)
                if dot in _WALLCLOCK:
                    yield self.finding(
                        ctx, node,
                        f"`{dot}` reads the wall clock inside the "
                        "deterministic simulator; thread simulated time "
                        "through explicitly")
                elif dot is not None and dot.startswith("random.") \
                        and dot != "random.Random":
                    # random.Random(seed) is the sanctioned seeded
                    # generator; the module-level functions share
                    # ambient global state
                    yield self.finding(
                        ctx, node,
                        f"stdlib `{dot}` uses ambient global RNG state; "
                        "use a seeded generator carried in the scenario")
                elif dot in _MATERIALIZERS and len(node.args) == 1 \
                        and _is_set_typed(node.args[0], set_names, ctx):
                    yield self.finding(
                        ctx, node,
                        f"`{dot}()` of a set materializes hash order "
                        "into trace/schedule output; use sorted(...)")
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                if _is_set_typed(node.iter, set_names, ctx):
                    yield self.finding(
                        ctx, node,
                        "iteration over an unordered set feeds "
                        "simulator output in hash order; iterate "
                        "sorted(...) for a canonical order")
            elif isinstance(node, (ast.ListComp, ast.SetComp,
                                   ast.DictComp, ast.GeneratorExp)):
                yield from self._check_comprehension(node, set_names, ctx)

    def _check_comprehension(self, node, set_names, ctx
                             ) -> Iterable[Finding]:
        for comp in node.generators:
            if not _is_set_typed(comp.iter, set_names, ctx):
                continue
            par = astutil.parent(node)
            if isinstance(par, ast.Call) \
                    and ctx.resolve(par.func) in _ORDER_FREE:
                continue                 # sorted(x for x in s) etc.
            if isinstance(node, ast.SetComp):
                continue                 # set -> set: still unordered
            yield self.finding(
                ctx, comp.iter,
                "comprehension over an unordered set feeds simulator "
                "output in hash order; wrap the source in sorted(...)")

    @staticmethod
    def _set_typed_names(ctx: ModuleContext) -> set[str]:
        """Names (and ``self.x`` dotted attributes) assigned a set
        anywhere in the module — cross-method, best effort."""
        names: set[str] = set()

        def _set_ann(ann: ast.AST | None) -> bool:
            return (isinstance(ann, ast.Name)
                    and ann.id in ("set", "frozenset")) or \
                (isinstance(ann, ast.Subscript)
                 and isinstance(ann.value, ast.Name)
                 and ann.value.id in ("set", "frozenset"))

        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                args = node.args
                for a in (args.posonlyargs + args.args + args.kwonlyargs):
                    if _set_ann(a.annotation):
                        names.add(a.arg)
            value = None
            targets: list[ast.AST] = []
            if isinstance(node, ast.Assign):
                value, targets = node.value, node.targets
            elif isinstance(node, ast.AnnAssign):
                is_set_ann = _set_ann(node.annotation)
                if is_set_ann or node.value is not None:
                    value, targets = node.value, [node.target]
                if is_set_ann:
                    for t in targets:
                        d = astutil.dotted(t, {})
                        if d:
                            names.add(d)
            if value is not None and _is_set_typed(value, names, ctx):
                for t in targets:
                    d = astutil.dotted(t, {})
                    if d:
                        names.add(d)
        return names
