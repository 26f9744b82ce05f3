"""KERNEL: fallbacks that hide the device or the kernel.

Counterpart of ``repro.lint.rules.pallas``, scoped to modules under
``repro_torch/kernels/`` that load a compiled library (``ctypes``, a
``_build.library(...)`` call, ``torch.utils.cpp_extension`` or
``triton``).  A kernel wrapper of the port runs its kernel on CUDA
operands and its plain version on CPU operands, and raises for anything
else: a silent fallback would let a broken build or launch pass every
check while the plain version does the work.  Two checks:

* an ``except`` around a kernel build or launch whose handler does not
  raise but calls the plain version (a ``*_ref`` call or ``impl="ref"``),
  passes or returns;
* a dispatch on ``torch.cuda.is_available()``: whether the machine has a
  card says nothing about the operand, so the choice belongs to the
  operand's device or ``impl=`` (``int8_quant/ops.py::_impl`` is the
  clean form).

The reference's index-map arity, out-dtype and ``pl.when`` checks police
Pallas's Python-side grid description; a CUDA kernel's grid lives in C++,
so they have no counterpart here (see the README).
"""

from __future__ import annotations

import ast
from typing import Iterable

from ..engine import ModuleContext
from ..findings import Finding
from ..registry import Rule, register

_LOADERS = {"ctypes.CDLL", "ctypes.cdll.LoadLibrary",
            "torch.utils.cpp_extension.load",
            "torch.utils.cpp_extension.load_inline",
            "torch.ops.load_library"}
# Last name of a call that builds, loads or launches a kernel.
_KERNEL_CALLS = {"library", "build", "load", "load_inline", "_fn",
                 "_launch", "launch"}


def _is_kernel_call(call: ast.Call, ctx: ModuleContext) -> bool:
    if isinstance(call.func, ast.Call):           # _fn(dtype)(ptrs, ...)
        return True
    dot = ctx.resolve(call.func) or ""
    return dot in _LOADERS or dot.startswith("ctypes.") \
        or dot.split(".")[-1] in _KERNEL_CALLS


def _falls_back(handler: ast.ExceptHandler) -> bool:
    nodes = [n for stmt in handler.body for n in ast.walk(stmt)]
    if any(isinstance(n, ast.Raise) for n in nodes):
        return False
    for n in nodes:
        if isinstance(n, (ast.Return, ast.Pass)):
            return True
        if isinstance(n, ast.Call):
            name = n.func.attr if isinstance(n.func, ast.Attribute) \
                else getattr(n.func, "id", "")
            if name.endswith("_ref") or any(
                    kw.arg == "impl" and isinstance(kw.value, ast.Constant)
                    and kw.value.value == "ref" for kw in n.keywords):
                return True
    return False


@register
class KernelRule(Rule):
    name = "KERNEL"
    summary = ("a kernel build or launch whose failure falls back to the "
               "plain version, or a dispatch on torch.cuda.is_available()")

    def applies(self, ctx: ModuleContext) -> bool:
        if "kernels/" not in ctx.relpath:
            return False
        if any(v == "ctypes" or v.startswith(("triton",
                                              "torch.utils.cpp_extension"))
               for v in ctx.aliases.values()):
            return True
        return any(isinstance(n, ast.Call) and _is_kernel_call(n, ctx)
                   for n in ast.walk(ctx.tree))

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Try) and any(
                    isinstance(n, ast.Call) and _is_kernel_call(n, ctx)
                    for stmt in node.body for n in ast.walk(stmt)):
                for handler in node.handlers:
                    if _falls_back(handler):
                        yield self.finding(
                            ctx, handler,
                            "an except around a kernel build or launch "
                            "falls back instead of raising: a broken kernel "
                            "would pass unseen while the plain version "
                            "works; let the error propagate")
            elif isinstance(node, ast.Call) \
                    and ctx.resolve(node.func) == "torch.cuda.is_available":
                yield self.finding(
                    ctx, node,
                    "kernel dispatch on torch.cuda.is_available() ignores "
                    "where the operand lives; dispatch on its device "
                    "(`t.is_cuda`) or on impl=")
