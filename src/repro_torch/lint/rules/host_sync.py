"""HOST-SYNC: implicit device synchronization inside hot-path functions.

Counterpart of ``repro.lint.rules.host_sync``.  The port's speed rests on
asynchronous CUDA dispatch: the host queues a whole period or decode
block and synchronizes ONCE at its boundary.  An implicit transfer inside
the hot region — ``x.item()``, ``x.tolist()``, ``x.numpy()``,
``float(x)`` / ``int(x)`` / ``bool(x)``, ``np.asarray(x)``, ``if x:`` on
a device tensor, a boolean mask or ``torch.nonzero`` (whose output shape
the host must read), ``print(x)`` — blocks the host mid-period and
serializes the work the schedule planned to overlap.

The rule polices only functions marked with ``@hot_path``
(:mod:`repro_torch.lint.hotpath`).  The *explicit* forms — ``.cpu()``,
``.to("cpu")``, ``torch.cuda.synchronize()``, ``Event.synchronize()``
and ``Stream.synchronize()`` — are the blessed counterparts of
``jax.device_get`` and ``jax.block_until_ready``: one deliberate, batched
read per drain point.  Values they produce are tracked as host-side, so
``t.cpu().tolist()`` is clean.

:func:`implicit_syncs` and :func:`is_explicit_sync` are shared with the
RECOMPILE rule, which forbids both kinds inside a capture.
"""

from __future__ import annotations

import ast
from typing import Iterable, Iterator

from .. import astutil
from ..engine import ModuleContext
from ..findings import ERROR, WARNING, Finding
from ..registry import Rule, register

# PRESUMED: the result of a call the rule cannot resolve.  A hot path
# mostly dispatches device work, so a conversion of one is flagged; a
# branch on one is not (a helper returning a Python value is as likely).
DEVICE, PRESUMED, HOST, UNKNOWN = "device", "presumed", "host", "unknown"

# Calls whose result is host-resident (or plain Python).
_HOST_CALLS = {
    "numpy.asarray", "numpy.array", "numpy.shape",
    "float", "int", "bool", "str", "len", "range", "enumerate", "sorted",
    "list", "tuple", "dict", "set", "min", "max", "sum", "abs", "zip",
    "isinstance", "getattr", "hasattr", "repr", "callable",
    "torch.cuda.synchronize", "torch.cuda.is_available",
    "torch.cuda.device_count", "torch.device", "torch.Size",
}
_HOST_ROOTS = ("numpy", "math", "time", "itertools", "functools",
               "operator", "collections", "statistics")
# Calls that hand back what they are given (an iterator over a host list
# yields host values).
_PASSTHROUGH = {"iter", "next", "reversed"}
# Reads of tensor metadata: plain Python values, no sync.
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "is_meta",
                 "layout", "requires_grad", "type"}
_STATIC_METHODS = {"size", "dim", "numel", "data_ptr", "element_size",
                   "stride", "is_contiguous", "get_device", "nelement"}
_SYNC_METHODS = {"item", "tolist", "numpy"}
# Methods whose result lives on the host.
_HOST_METHODS = _SYNC_METHODS | {"cpu", "synchronize", "elapsed_time",
                                 "query"}
_NUMPY = {"numpy.asarray", "numpy.array"}
_CONVERSIONS = {"float", "int", "bool"}
# Data-dependent output shapes: the host must read a count.
_SHAPE_SYNCS = {"torch.nonzero", "torch.masked_select", "torch.argwhere"}
_SHAPE_METHODS = {"nonzero", "masked_select", "argwhere"}

_SUPPRESS = ("; make it explicit and batched (one `.cpu()` / "
             "`torch.cuda.synchronize()` per drain), move it off the hot "
             "path, or add `# repro-lint: disable=HOST-SYNC -- why`")


def _is_cpu(node: ast.AST | None, ctx: ModuleContext) -> bool:
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.startswith("cpu")
    return isinstance(node, ast.Call) \
        and ctx.resolve(node.func) == "torch.device" \
        and bool(node.args) and _is_cpu(node.args[0], ctx)


def is_explicit_sync(call: ast.Call, ctx: ModuleContext) -> bool:
    """``.cpu()``, ``.to("cpu")`` / ``.to(device="cpu")``,
    ``torch.cuda.synchronize()``, ``<event or stream>.synchronize()``."""
    if ctx.resolve(call.func) == "torch.cuda.synchronize":
        return True
    if not isinstance(call.func, ast.Attribute):
        return False
    attr = call.func.attr
    if attr in ("cpu", "synchronize"):
        return True
    if attr == "to":
        dev = call.args[0] if call.args else astutil.keyword(call, "device")
        return _is_cpu(dev, ctx)
    return False


def _classify(node: ast.AST, env: dict[str, str], ctx: ModuleContext
              ) -> str:
    """HOST / DEVICE / PRESUMED / UNKNOWN provenance of an expression,
    given the per-function name environment."""
    if isinstance(node, ast.Constant):
        return HOST
    if isinstance(node, ast.Name):
        return env.get(node.id, UNKNOWN)
    if isinstance(node, ast.Attribute):
        if node.attr in _STATIC_ATTRS:
            return HOST
        return _classify(node.value, env, ctx)
    if isinstance(node, (ast.Subscript, ast.Starred)):
        return _classify(node.value, env, ctx)
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Attribute) and (
                node.func.attr in _HOST_METHODS | _STATIC_METHODS
                or is_explicit_sync(node, ctx)):
            return HOST
        dot = ctx.resolve(node.func)
        if dot in _HOST_CALLS:
            return HOST
        if dot in _PASSTHROUGH and node.args:
            return _classify(node.args[0], env, ctx)
        if dot is not None:
            root = dot.split(".")[0]
            if root == "torch":
                return DEVICE
            if root in _HOST_ROOTS:
                return HOST
            if root in env:                 # method of / call through a
                base = env[root]            # locally-classified value
                return PRESUMED if base == UNKNOWN else base
        elif isinstance(node.func, ast.Attribute):
            # a method of a computed value (host[:n].reshape(...)) lives
            # where that value lives
            base = _classify(node.func.value, env, ctx)
            if base in (HOST, DEVICE):
                return base
        return PRESUMED
    if isinstance(node, ast.Compare) and any(
            isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
            for op in node.ops):
        return HOST                         # identity / container tests
    if isinstance(node, (ast.BinOp, ast.BoolOp, ast.Compare, ast.UnaryOp,
                         ast.IfExp, ast.Tuple, ast.List, ast.Dict,
                         ast.JoinedStr, ast.FormattedValue)):
        kinds = [_classify(c, env, ctx) for c in ast.iter_child_nodes(node)
                 if isinstance(c, ast.expr)]
        for kind in (DEVICE, PRESUMED):
            if kind in kinds:
                return kind
        if kinds and all(k == HOST for k in kinds):
            return HOST
        return UNKNOWN
    return UNKNOWN


def _is_mask_expr(node: ast.AST, env: dict[str, str],
                  ctx: ModuleContext) -> bool:
    """A boolean tensor built in place: a comparison, ``~``/``not`` or a
    bitwise combination of device values."""
    boolean = isinstance(node, ast.Compare) or (
        isinstance(node, ast.UnaryOp)
        and isinstance(node.op, (ast.Invert, ast.Not))) or (
        isinstance(node, ast.BinOp)
        and isinstance(node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)))
    return boolean and _classify(node, env, ctx) in (DEVICE, PRESUMED)


def build_env(fn: ast.AST, ctx: ModuleContext
              ) -> tuple[dict[str, str], set[str]]:
    """One forward pass (source order, control flow ignored) assigning
    HOST/DEVICE provenance to local names; also the names bound to
    boolean device masks."""
    env: dict[str, str] = {}
    masks: set[str] = set()
    nodes: list[ast.AST] = sorted(
        astutil.walk_no_nested_functions(fn),
        key=lambda n: (getattr(n, "lineno", 0),
                       getattr(n, "col_offset", 0)))
    for node in nodes:
        if isinstance(node, ast.Assign):
            kind = _classify(node.value, env, ctx)
            mask = _is_mask_expr(node.value, env, ctx)
            for name in astutil.assign_target_names(node):
                env[name] = kind
                (masks.add if mask else masks.discard)(name)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            if isinstance(node.target, ast.Name):
                env[node.target.id] = _classify(node.value, env, ctx)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            kind = _classify(node.iter, env, ctx)
            for name in astutil.assign_target_names(node):
                env[name] = kind
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for comp in node.generators:
                kind = _classify(comp.iter, env, ctx)
                for t in ast.walk(comp.target):
                    if isinstance(t, ast.Name):
                        env[t.id] = kind
    return env, masks


def implicit_syncs(nodes: Iterable[ast.AST], env: dict[str, str],
                   masks: set[str], ctx: ModuleContext
                   ) -> Iterator[tuple[ast.AST, str, str]]:
    """(node, what, severity) for every implicit sync among ``nodes``
    under the function's environment; ``what`` names the sync."""
    for node in nodes:
        if isinstance(node, ast.Call):
            yield from _check_call(node, env, ctx)
        elif isinstance(node, (ast.If, ast.While, ast.IfExp)):
            if _classify(node.test, env, ctx) == DEVICE:
                kw = "while" if isinstance(node, ast.While) else "if"
                yield (node, f"`{kw}` on a device value calls bool() on "
                             "it: an implicit blocking transfer", ERROR)
        elif isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Load):
            idx = node.slice
            mask = (isinstance(idx, ast.Name) and idx.id in masks) \
                or _is_mask_expr(idx, env, ctx)
            if mask and _classify(node.value, env, ctx) != HOST:
                yield (node, "boolean-mask indexing of a device value: "
                             "its output shape needs a blocking read",
                       ERROR)


def _check_call(node: ast.Call, env: dict[str, str], ctx: ModuleContext
                ) -> Iterator[tuple[ast.AST, str, str]]:
    dot = ctx.resolve(node.func)
    if dot in _NUMPY:
        if node.args and _classify(node.args[0], env, ctx) != HOST:
            yield (node, f"`{dot}` of a device value forces a blocking "
                         "device->host read", ERROR)
        return
    if dot == "print":
        if any(_classify(a, env, ctx) != HOST for a in node.args):
            yield (node, "`print` of a possibly-device value blocks "
                         "dispatch", WARNING)
        return
    if dot in _CONVERSIONS and len(node.args) == 1:
        if _classify(node.args[0], env, ctx) in (DEVICE, PRESUMED):
            yield (node, f"`{dot}()` of a device value is an implicit "
                         "blocking transfer", ERROR)
        return
    if dot in _SHAPE_SYNCS or (dot == "torch.where" and len(node.args) == 1):
        yield (node, f"`{dot}` has a data-dependent output shape: the host "
                     "blocks to read it", ERROR)
        return
    if not isinstance(node.func, ast.Attribute) \
            or _classify(node.func.value, env, ctx) == HOST:
        return
    attr = node.func.attr
    if attr in _SYNC_METHODS and not node.args:
        yield (node, f"`.{attr}()` synchronously materializes a device "
                     "value", ERROR)
    elif attr in _SHAPE_METHODS:
        yield (node, f"`.{attr}()` has a data-dependent output shape: the "
                     "host blocks to read it", ERROR)


def function_scopes(fn: ast.AST) -> Iterator[ast.AST]:
    """``fn`` and every function nested in it (they run on its path)."""
    yield fn
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not fn:
            yield node


@register
class HostSyncRule(Rule):
    name = "HOST-SYNC"
    summary = ("implicit device sync (.item / .tolist / .numpy / float / "
               "if tensor / np.asarray / boolean mask / nonzero / print of "
               "a device value) inside a @hot_path function")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for info in ctx.hot_functions():
            for fn in function_scopes(info.node):
                env, masks = build_env(fn, ctx)
                for node, what, sev in implicit_syncs(
                        astutil.walk_no_nested_functions(fn), env, masks,
                        ctx):
                    yield self.finding(ctx, node,
                                       f"{what} in a hot path{_SUPPRESS}",
                                       severity=sev)
