"""Every public name of the JAX package has a counterpart in the port.

For each module of ``src/repro`` (found on disk, one case a module), the
module of the same dotted path under ``repro_torch`` must exist and
carry every name of the reference module's ``__all__``; a module
without ``__all__`` is held to the public functions and classes it
defines.  The reference's names are read from its source with ``ast``,
so no reference module is imported: ``repro.launch.dryrun`` sets
``XLA_FLAGS`` when imported, which would reach every later JAX test on
the same worker.  The pool classes of ``serve.cache`` are held to every
public attribute of their reference classes (methods and properties).

What the port leaves out on purpose is listed in ``GAPS`` and
``MODULE_GAPS``, each with its ROADMAP C5 reason.  A listed gap that the
port has closed, or that the reference no longer has, fails too, so the
lists stay true.
"""

from __future__ import annotations

import ast
import importlib
import inspect
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src" / "repro"

# modules of the reference with no torch form
MODULE_GAPS = {
    "repro.analysis.hlo": "the port has no HLO: the dry run counts ops on "
                          "meta tensors (C5)",
    "repro.analysis.hlo_costs": "the port has no HLO: "
                                "analysis.op_costs takes its place (C5)",
    "repro.lint.rules.pallas": "no Pallas in the port: lint/rules/kernel.py "
                               "takes its place (C5)",
    **{f"repro.kernels.{k}.kernel": "the Pallas kernel; its CUDA port is "
                                    f"kernels/csrc/{k}.cu"
       for k in ("flash_attention", "fused_adam_sync", "int8_quant",
                 "paged_attention", "ssd_scan")},
}

_SLOT_FACTORIES = ("the reference's jitted make_slot_* factories; the "
                   "port's slot steps are plain functions in "
                   "runtime/step.py (C5)")
_SCATTER = ("the reference's jitted scatter factories; the port's "
            "counterpart is the plain serve.cache.prefill_scatter (C5)")
_ASTUTIL = ("helpers only the JAX lint rules use (the Pallas and jit "
            "argument readers); lint/astutil.py copies the rest (C5)")

# (module, name) the port leaves out on purpose
GAPS = {
    **{("repro.runtime", n): _SLOT_FACTORIES for n in (
        "make_slot_decode_step", "make_slot_prefill_step",
        "make_slot_refeed_step")},
    **{("repro.runtime.step", n): _SLOT_FACTORIES for n in (
        "make_slot_prefill_step", "make_slot_prefill_step_batched",
        "make_slot_refeed_step", "make_slot_refeed_step_batched",
        "make_slot_decode_step", "make_slot_decode_step_paged")},
    ("repro.serve.cache", "make_prefill_scatter"): _SCATTER,
    ("repro.serve.cache", "make_prefill_scatter_batched"): _SCATTER,
    ("repro.analysis", "parse_collectives"): (
        "reads HLO text; the port reckons collectives from the specs and "
        "the plan (analysis/collectives.py, C5)"),
    ("repro.models.layers", "Init"): (
        "the reference's keyed initializer stream; the port's init helpers "
        "take a torch.Generator directly (C5)"),
    **{("repro.lint.astutil", n): _ASTUTIL for n in (
        "root_name", "const_value", "int_tuple", "str_tuple")},
}

POOL_CLASSES = ("CachePool", "PagedCachePool")


def _modules() -> dict[str, Path]:
    out = {}
    for path in sorted(SRC.rglob("*.py")):
        parts = path.relative_to(SRC.parent).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out[".".join(parts)] = path
    return out


MODULES = _modules()


def _public(path: Path) -> list[str]:
    """``__all__``, or the public functions and classes the module defines.

    An ``__all__`` that is not a literal (``repro.core``'s lists
    ``dir()``) is taken as every public name bound before it, the
    submodules that its relative imports bind included.
    """
    bound, defs = [], []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            defs.append(node.name)
            bound.append(node.name)
        elif isinstance(node, ast.Import):
            bound += [(a.asname or a.name).split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level and node.module:
                bound.append(node.module.split(".")[0])
            bound += [a.asname or a.name for a in node.names]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names = [t.id for t in targets if isinstance(t, ast.Name)]
            if "__all__" in names:
                try:
                    return list(ast.literal_eval(node.value))
                except ValueError:
                    return sorted({n for n in bound if not n.startswith("_")})
            bound += names
    return [n for n in defs if not n.startswith("_")]


def _port_name(name: str) -> str:
    return "repro_torch" + name[len("repro"):]


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


@pytest.mark.parametrize("name", list(MODULES))
def test_module_names_have_counterparts(name):
    if name in MODULE_GAPS:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(_port_name(name))
        return
    port = importlib.import_module(_port_name(name))
    public = _public(MODULES[name])
    missing = [n for n in public if not hasattr(port, n)
               and (name, n) not in GAPS]
    assert not missing, (f"{_port_name(name)} lacks {missing} of "
                         f"{name}'s public names")
    for (mod, n), why in GAPS.items():
        if mod == name:
            assert n in public, f"gap {n} ({why}) is gone from {name}"
            assert not hasattr(port, n), f"gap {n} is closed: unlist it"


def test_every_listed_gap_names_a_module():
    listed = {m for m, _ in GAPS} | set(MODULE_GAPS)
    assert listed <= set(MODULES)


@pytest.mark.parametrize("cls", POOL_CLASSES)
def test_pool_class_attributes(jax, cls):
    from repro.serve import cache as ref_cache
    from repro_torch.serve import cache as port_cache
    ref, port = getattr(ref_cache, cls), getattr(port_cache, cls)
    public = [n for n in dir(ref) if not n.startswith("_")]
    missing = [n for n in public if not hasattr(port, n)]
    assert not missing, f"repro_torch {cls} lacks {missing}"
    for n in public:
        assert isinstance(inspect.getattr_static(port, n), property) == \
            isinstance(inspect.getattr_static(ref, n), property), n
