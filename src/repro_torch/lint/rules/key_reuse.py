"""KEY-REUSE: random streams that are shared or ambient.

Counterpart of ``repro.lint.rules.key_reuse``.  JAX keys are values, and
the hazard is one key consumed twice.  A ``torch.Generator`` is stateful,
so the hazards take three other forms:

* a random draw with no ``generator=`` (``torch.rand*``, ``randn*``,
  ``randint*``, ``randperm``, ``normal``, ``bernoulli``, ``multinomial``
  and the in-place ``normal_``, ``uniform_``, ``bernoulli_``,
  ``random_``, ``exponential_``) reads the process-wide default
  generator, which every other caller also advances: the stream depends
  on what ran before;
* a global reseed (``torch.manual_seed``, ``torch.cuda.manual_seed*``)
  in library code resets that stream under every other caller;
* two generators seeded from the same expression in one scope give
  identical streams — the literal counterpart of a reused key.  A seed
  expression is forgotten once a name in it is rebound (a loop target,
  an assignment), so ``manual_seed(base + k)`` per worker is clean.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .. import astutil
from ..engine import ModuleContext
from ..findings import Finding
from ..registry import Rule, register

_DRAWS = {f"torch.{f}" for f in (
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "normal", "bernoulli", "multinomial")}
_INPLACE_DRAWS = {"normal_", "uniform_", "bernoulli_", "random_",
                  "exponential_"}
_RESEEDS = {"torch.manual_seed", "torch.random.manual_seed",
            "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
            "torch.seed", "torch.cuda.seed", "torch.cuda.seed_all"}
_GENERATOR = "torch.Generator"


@register
class KeyReuseRule(Rule):
    name = "KEY-REUSE"
    summary = ("a random draw without generator=, a global reseed, or two "
               "generators seeded from the same expression")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for call in ast.walk(ctx.tree):
            if isinstance(call, ast.Call):
                yield from self._ambient(call, ctx)
        yield from self._scan(ctx.tree.body, ctx)
        for info in ctx.functions:
            yield from self._scan(info.node.body, ctx)

    def _ambient(self, call: ast.Call, ctx: ModuleContext
                 ) -> Iterable[Finding]:
        dot = ctx.resolve(call.func)
        if dot in _RESEEDS:
            yield self.finding(
                ctx, call,
                f"`{dot}` reseeds the process-wide generator under every "
                "other caller; seed a torch.Generator and pass it")
            return
        draw = dot if dot in _DRAWS else (
            f".{call.func.attr}()" if isinstance(call.func, ast.Attribute)
            and call.func.attr in _INPLACE_DRAWS else None)
        if draw is not None and astutil.keyword(call, "generator") is None:
            yield self.finding(
                ctx, call,
                f"`{draw}` without generator= draws from the process-wide "
                "default stream, which every other caller advances; pass "
                "a seeded torch.Generator")

    def _scan(self, body: list[ast.stmt], ctx: ModuleContext
              ) -> Iterable[Finding]:
        gens: set[str] = set()            # names bound to a Generator
        seeds: dict[str, tuple[int, set[str]]] = {}  # dump -> (line, names)
        for stmt in astutil.iter_statements(body):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            for call in astutil.stmt_nodes(stmt):
                if not (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Attribute)
                        and call.func.attr == "manual_seed"
                        and len(call.args) == 1):
                    continue
                recv = call.func.value
                if not ((isinstance(recv, ast.Call)
                         and ctx.resolve(recv.func) == _GENERATOR)
                        or (isinstance(recv, ast.Name) and recv.id in gens)):
                    continue
                key = ast.dump(call.args[0])
                if key in seeds:
                    yield self.finding(
                        ctx, call,
                        "a second generator seeded from the same expression "
                        f"(first at line {seeds[key][0]}) repeats its "
                        "stream; derive distinct seeds")
                else:
                    seeds[key] = (call.lineno, {
                        n.id for n in ast.walk(call.args[0])
                        if isinstance(n, ast.Name)})
            rebound = set(astutil.assign_target_names(stmt))
            for key in [k for k, (_, names) in seeds.items()
                        if names & rebound]:
                del seeds[key]
            if isinstance(stmt, ast.Assign) \
                    and isinstance(stmt.value, ast.Call) \
                    and ctx.resolve(stmt.value.func) == _GENERATOR:
                gens.update(rebound)
            else:
                gens -= rebound
