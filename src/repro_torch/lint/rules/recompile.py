"""RECOMPILE: capture and compile hazards on the hot path.

Counterpart of ``repro.lint.rules.recompile``, whose ``jax.jit`` hazards
take these forms in PyTorch:

* ``torch.compile``, ``torch.cuda.CUDAGraph()`` / ``torch.cuda.graph(...)``
  or ``torch.cuda.make_graphed_callables`` inside a ``for``/``while``
  body or a ``@hot_path`` function — every call compiles or captures
  anew.  Build the executable or graph once (the engine captures at
  construction, the runner before a period's time) and call or replay it
  here.  Comprehensions are exempt, as in the reference.
* A Python branch on a tensor value inside a ``@torch.compile`` function
  (a graph break or a guard per value) or inside the body of a ``with
  torch.cuda.graph(...)`` block (evaluated once, at capture) — a warning.
  Shape / dtype / device reads, ``is None`` and ``isinstance`` / ``len``
  / ``callable`` tests are static and exempt.
* A host sync inside such a capture body, implicit or explicit: a
  capture cannot read the device (an error).
* ``torch.utils.checkpoint.checkpoint(...)`` without
  ``preserve_rng_state=False``: the recompute stashes and restores the
  CUDA RNG state, which a graph capture may not read.

The reference's unhashable-static-argument check has no torch form
(``torch.compile`` takes no static argument list); see the README.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .. import astutil
from ..engine import ModuleContext
from ..findings import Finding, WARNING
from ..registry import Rule, register
from .host_sync import (DEVICE, _classify, build_env, implicit_syncs,
                        is_explicit_sync)

_COMPILE = "torch.compile"
_GRAPH = "torch.cuda.graph"
_CAPTURES = {_COMPILE, "torch.cuda.CUDAGraph", _GRAPH,
             "torch.cuda.make_graphed_callables"}
_CHECKPOINT = {"torch.utils.checkpoint.checkpoint",
               "torch.utils.checkpoint.checkpoint_sequential"}
# attribute reads on a tensor that produce static python values
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda"}


def _compile_decorated(fn: ast.FunctionDef | ast.AsyncFunctionDef,
                       ctx: ModuleContext) -> bool:
    for dec in fn.decorator_list:
        if ctx.resolve(dec) == _COMPILE:
            return True
        if isinstance(dec, ast.Call):
            dot = ctx.resolve(dec.func)
            if dot == _COMPILE:
                return True
            if dot in ("functools.partial", "partial") and dec.args \
                    and ctx.resolve(dec.args[0]) == _COMPILE:
                return True
    return False


def _graph_blocks(ctx: ModuleContext) -> Iterable[ast.With]:
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(i.context_expr, ast.Call)
                and ctx.resolve(i.context_expr.func) == _GRAPH
                for i in node.items):
            yield node


def _body_nodes(body: list[ast.stmt]) -> Iterable[ast.AST]:
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield stmt
        yield from astutil.walk_no_nested_functions(stmt)


@register
class RecompileRule(Rule):
    name = "RECOMPILE"
    summary = ("torch.compile / CUDA-graph capture per call site (in a "
               "loop / hot path), branches and host syncs inside a "
               "capture, checkpoint() reading the RNG state")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        yield from self._capture_call_sites(ctx)
        yield from self._compiled_functions(ctx)
        yield from self._graph_bodies(ctx)
        yield from self._checkpoints(ctx)

    # --------------------------------------- compile/capture in loop/hot path
    def _capture_call_sites(self, ctx: ModuleContext) -> Iterable[Finding]:
        for call in ctx.calls(*_CAPTURES):
            what = ctx.resolve(call.func)
            fn = astutil.enclosing_function(call)
            if astutil.enclosing_loop(call) is not None:
                yield self.finding(
                    ctx, call,
                    f"{what} inside a loop compiles or captures anew "
                    "every iteration; build it once and call or replay it "
                    "here")
                continue
            info = ctx.function_info(fn) if fn is not None else None
            if info is not None and info.is_hot:
                yield self.finding(
                    ctx, call,
                    f"{what} inside a @hot_path function compiles or "
                    "captures per call; build it once at setup and call "
                    "or replay it here")

    # ------------------------------------------------- @torch.compile bodies
    def _compiled_functions(self, ctx: ModuleContext) -> Iterable[Finding]:
        defs = {info.node.name: info.node for info in ctx.functions}
        seen: list[ast.AST] = [info.node for info in ctx.functions
                               if _compile_decorated(info.node, ctx)]
        for call in ctx.calls(_COMPILE):         # torch.compile(local_def)
            if call.args and isinstance(call.args[0], ast.Name):
                fn = defs.get(call.args[0].id)
                if fn is not None and fn not in seen:
                    seen.append(fn)
        for fn in seen:
            params = set(astutil.param_names(fn))
            for node in astutil.walk_no_nested_functions(fn):
                if not isinstance(node, (ast.If, ast.While)):
                    continue
                name = self._tensor_name_in_test(node.test, params)
                if name is not None:
                    yield self.finding(
                        ctx, node,
                        f"Python branch on tensor argument `{name}` inside "
                        "a torch.compile function breaks the graph or "
                        "guards per value; use torch.where / torch.cond",
                        severity=WARNING)
            yield from self._syncs_in(fn.body, fn, ctx,
                                      "a torch.compile function")

    @staticmethod
    def _tensor_name_in_test(test: ast.AST, params: set[str]
                             ) -> str | None:
        if isinstance(test, ast.Compare) and \
                any(isinstance(op, (ast.Is, ast.IsNot))
                    for op in test.ops):
            return None                         # `x is None` is static
        for node in ast.walk(test):
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Name) and \
                        node.func.id in ("isinstance", "len", "callable"):
                    return None                 # static-shaped predicate
            if isinstance(node, ast.Name) and node.id in params:
                par = astutil.parent(node)
                if isinstance(par, ast.Attribute) \
                        and par.attr in _STATIC_ATTRS:
                    continue                    # x.shape / x.ndim: static
                return node.id
        return None

    # ------------------------------------------- with torch.cuda.graph(...)
    def _graph_bodies(self, ctx: ModuleContext) -> Iterable[Finding]:
        for block in _graph_blocks(ctx):
            fn = astutil.enclosing_function(block)
            env = build_env(fn, ctx)[0] if fn is not None else {}
            for node in _body_nodes(block.body):
                if isinstance(node, (ast.If, ast.While)) \
                        and _classify(node.test, env, ctx) == DEVICE:
                    yield self.finding(
                        ctx, node,
                        "Python branch on a tensor value inside a CUDA "
                        "graph capture is taken once, at capture, and "
                        "replayed for every value; use torch.where",
                        severity=WARNING)
            yield from self._syncs_in(block.body, fn, ctx,
                                      "a CUDA graph capture")

    def _syncs_in(self, body: list[ast.stmt], fn: ast.AST | None,
                  ctx: ModuleContext, where: str) -> Iterable[Finding]:
        env, masks = build_env(fn, ctx) if fn is not None else ({}, set())
        nodes = list(_body_nodes(body))
        for node, what, _ in implicit_syncs(nodes, env, masks, ctx):
            if not isinstance(node, (ast.If, ast.While, ast.IfExp)):
                yield self.finding(ctx, node,
                                   f"host sync inside {where}: {what}")
        for node in nodes:
            if isinstance(node, ast.Call) and is_explicit_sync(node, ctx):
                yield self.finding(
                    ctx, node,
                    f"explicit host sync inside {where}: a capture cannot "
                    "read the device; sync before it or after the replay")

    # ------------------------------------------------------------ checkpoint
    def _checkpoints(self, ctx: ModuleContext) -> Iterable[Finding]:
        for call in ctx.calls(*_CHECKPOINT):
            kw = astutil.keyword(call, "preserve_rng_state")
            if not (isinstance(kw, ast.Constant) and kw.value is False):
                yield self.finding(
                    ctx, call,
                    "checkpoint() without preserve_rng_state=False reads "
                    "and restores the CUDA RNG state, which a graph "
                    "capture may not do; pass preserve_rng_state=False "
                    "(draw no randomness inside the recomputed region)")

