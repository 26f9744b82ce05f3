"""repro_torch.lint against snippets and tmp files (no tensors, no JAX):
each rule fires on its PyTorch hazard and stays silent on the nearest
legitimate idiom; pragmas, baseline, JSON report and CLI exit codes
equal to ``repro.lint``'s on the same text; SIM-DETERMINISM's findings
equal to the reference's on the same sources; the four acceptance
injections of ``tests/test_lint.py`` in their JAX form under
``repro.lint`` and their torch form under ``repro_torch.lint``, firing
the counterpart rule on the same line; and the port's tree lints clean
with the reference's 14 hot functions marked."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

import repro.lint as jlint
from repro.lint import baseline as jbaseline
from repro.lint import report as jreport
from repro.lint.__main__ import main as jmain
from repro_torch.lint import (ERROR, WARNING, Finding, all_rules, consumes,
                              hot_path, lint_paths, lint_text)
from repro_torch.lint import baseline as baseline_io
from repro_torch.lint import report
from repro_torch.lint.__main__ import main as lint_main
from repro_torch.lint.engine import build_context

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src"


def rules_of(findings):
    return [f.rule for f in findings]


HOT = """
import numpy as np
import torch
from repro_torch.lint import hot_path
"""


def hot(body: str) -> str:
    """``body`` (4-space indented) as a hot function ``tick(self, x)``."""
    return HOT + "\n@hot_path\ndef tick(self, x):\n" + body


# ---------------------------------------------------------------- HOST-SYNC

def test_host_sync_flags_float_of_loss_in_period_loop():
    src = HOT + """
class Runner:
    @hot_path
    def run_period(self, steps):
        state = self.state
        for r in range(steps):
            state, metrics = self.step_fn(state, self.data.batch(r))
            self.history.append(float(metrics["loss"]))
        return state
"""
    findings = lint_text(src, "runner.py")
    assert rules_of(findings) == ["HOST-SYNC"]
    assert findings[0].severity == ERROR
    assert "float" in findings[0].message


@pytest.mark.parametrize("body,what", [
    ("    y = torch.exp(x)\n    return y.item()\n", ".item()"),
    ("    y = torch.exp(x)\n    return y.tolist()\n", ".tolist()"),
    ("    y = torch.exp(x)\n    return y.numpy()\n", ".numpy()"),
    ("    y = torch.exp(x)\n    return int(y)\n", "int()"),
    ("    y = torch.exp(x)\n    return bool(y)\n", "bool()"),
    ("    y = torch.exp(x)\n    return np.asarray(y)\n", "numpy.asarray"),
    ("    y = torch.exp(x)\n    return np.array(y)\n", "numpy.array"),
    ("    y = torch.exp(x)\n    if y:\n        return 1\n", "`if`"),
    ("    y = torch.sum(x)\n    while y > 0:\n        y = y - 1\n",
     "`while`"),
    ("    y = torch.exp(x)\n    return y[y > 0]\n", "boolean-mask"),
    ("    y = torch.exp(x)\n    m = y > 0\n    return y[m]\n",
     "boolean-mask"),
    ("    y = torch.exp(x)\n    return torch.nonzero(y)\n", "torch.nonzero"),
    ("    y = torch.exp(x)\n    return y.nonzero()\n", ".nonzero()"),
    ("    y = torch.exp(x)\n    return torch.masked_select(y, y > 0)\n",
     "torch.masked_select"),
    ("    y = torch.exp(x)\n    return torch.where(y > 0)\n", "torch.where"),
])
def test_host_sync_flags_implicit_syncs(body, what):
    findings = lint_text(hot(body), "m.py")
    assert rules_of(findings) == ["HOST-SYNC"], findings
    assert findings[0].severity == ERROR and what in findings[0].message


@pytest.mark.parametrize("body", [
    # the blessed explicit forms, and what they hand back
    "    y = torch.exp(x)\n    return torch.cat([y, y]).cpu().tolist()\n",
    "    y = torch.exp(x)\n    return y.to('cpu').numpy()\n",
    "    y = torch.exp(x)\n    h = y.to(device='cpu')\n    return int(h[0])\n",
    "    y = torch.exp(x)\n    torch.cuda.synchronize()\n    return 1\n",
    "    ev = torch.cuda.Event()\n    ev.synchronize()\n    return 1\n",
    "    h = x.cpu().numpy()\n    toks = h[h >= 0]\n"
    "    return [int(t) for t in toks]\n",
    "    rows = iter(x.cpu().tolist())\n    if not next(rows):\n"
    "        return 0\n",
    # static reads, identity tests and host helpers
    "    y = torch.exp(x)\n    if y is None or y.shape[0] > 2:\n"
    "        return y.dim()\n",
    "    y = torch.exp(x)\n    if 'loss' in self.m and self.ready(y):\n"
    "        return float(y.numel())\n",
    "    y = torch.tensor([1.0, 2.0], device='cuda')\n    return y\n",
])
def test_host_sync_silent_on_explicit_and_static_forms(body):
    assert lint_text(hot(body), "m.py") == []


def test_host_sync_ignores_cold_functions():
    src = HOT + """
def summarize(metrics):
    return float(metrics["loss"].item())
"""
    assert lint_text(src, "m.py") == []


def test_host_sync_print_of_device_value_warns():
    findings = lint_text(hot("    y = torch.exp(x)\n    print(y)\n"
                             "    print('static label')\n"), "m.py")
    assert rules_of(findings) == ["HOST-SYNC"]
    assert findings[0].severity == WARNING


def test_host_sync_polices_nested_functions_of_a_hot_function():
    body = ("    def inner(z):\n        w = torch.exp(z)\n"
            "        return w.item()\n    return inner(x)\n")
    assert rules_of(lint_text(hot(body), "m.py")) == ["HOST-SYNC"]


# ---------------------------------------------------------------- RECOMPILE

@pytest.mark.parametrize("call", [
    "torch.compile(self.decode_fn)", "torch.cuda.CUDAGraph()",
    "torch.cuda.make_graphed_callables(self.decode_fn, (x,))"])
def test_recompile_flags_compile_or_capture_in_decode_tick(call):
    src = f"""
import torch

class Engine:
    def step(self, reqs):
        for req in reqs:
            fn = {call}
            out = fn(self.state, req)
        return out
"""
    findings = lint_text(src, "engine.py")
    assert rules_of(findings) == ["RECOMPILE"]
    assert findings[0].severity == ERROR and findings[0].line == 7


def test_recompile_flags_capture_in_hot_function():
    body = ("    g = torch.cuda.CUDAGraph()\n"
            "    with torch.cuda.graph(g):\n        self.body()\n")
    findings = lint_text(hot(body), "m.py")
    assert rules_of(findings) == ["RECOMPILE", "RECOMPILE"]
    assert all("@hot_path" in f.message for f in findings)


def test_recompile_silent_at_init_and_in_comprehensions():
    src = """
import torch

class Engine:
    def __init__(self, fns):
        self.graphs = [torch.cuda.CUDAGraph() for _ in fns]
        self.decode = torch.compile(fns[0])

    def step(self, reqs):
        for req in reqs:
            out = self.decode(self.state, req)
            self.graphs[0].replay()
        return out
"""
    assert lint_text(src, "engine.py") == []


def test_recompile_warns_on_tensor_branch_in_compiled_function():
    src = """
import torch

@torch.compile
def f(x, lo):
    if x > lo:
        return x
    return -x
"""
    findings = lint_text(src, "m.py")
    assert rules_of(findings) == ["RECOMPILE"]
    assert findings[0].severity == WARNING


def test_recompile_silent_on_static_branches_in_compiled_function():
    src = """
import torch

def f(x, mask):
    if mask is not None:
        x = x + mask
    if x.ndim == 2 and isinstance(x, torch.Tensor):
        x = x[None]
    return x

g = torch.compile(f)
"""
    assert lint_text(src, "m.py") == []


def test_recompile_flags_branch_and_syncs_in_capture_body():
    src = """
import torch

def capture(g, x):
    y = torch.exp(x)
    with torch.cuda.graph(g):
        if y.sum() > 0:
            y.mul_(2)
        n = y.item()
        torch.cuda.synchronize()
    return n
"""
    findings = lint_text(src, "m.py")
    assert [(f.rule, f.severity, f.line) for f in findings] == [
        ("RECOMPILE", WARNING, 7), ("RECOMPILE", ERROR, 9),
        ("RECOMPILE", ERROR, 10)]


def test_recompile_silent_on_capture_of_a_body_call():
    src = """
import torch

def capture(g, body):
    torch.cuda.synchronize()
    with torch.cuda.graph(g):
        body()
    return g
"""
    assert lint_text(src, "m.py") == []


@pytest.mark.parametrize("imp,call,bad", [
    ("from torch.utils.checkpoint import checkpoint", "checkpoint", True),
    ("import torch.utils.checkpoint as cp", "cp.checkpoint", True),
    ("import torch", "torch.utils.checkpoint.checkpoint", True),
    ("from torch.utils.checkpoint import checkpoint", "checkpoint", False),
])
def test_recompile_checkpoint_must_not_read_rng_state(imp, call, bad):
    kw = "" if bad else ", preserve_rng_state=False"
    src = f"{imp}\n\ndef f(fn, x):\n    return {call}(fn, x, " \
          f"use_reentrant=False{kw})\n"
    assert rules_of(lint_text(src, "m.py")) == (["RECOMPILE"] if bad
                                                else [])


# ------------------------------------------------------------------- DONATE

CONSUMER = """
from repro_torch.lint import consumes

class Runner:
    @consumes("state")
    def run(self, state, n):
        return state

"""


def test_donate_flags_use_after_consume():
    src = CONSUMER + """
    def fit(self, state, n):
        self.run(state, n)
        return state.params
"""
    findings = lint_text(src, "m.py")
    assert rules_of(findings) == ["DONATE"]
    assert "state" in findings[0].message and findings[0].line == 12


@pytest.mark.parametrize("body", [
    # the rebind idiom
    "        for _ in range(n):\n            state = self.run(state, 1)\n"
    "        return state\n",
    # a consumption that leaves the scope
    "        if n:\n            return self.run(state, n)\n"
    "        return self.run(state, 1)\n",
    # callee not resolvable statically: silent, as the reference
    "        self.other.run(state, n)\n        return state\n",
])
def test_donate_silent_on_rebind_return_and_unresolved(body):
    src = CONSUMER + "    def fit(self, state, n):\n" + body
    assert lint_text(src, "m.py") == []


def test_donate_flags_re_consumption_in_loop():
    src = CONSUMER + """
    def fit(self, state, n):
        outs = []
        for _ in range(n):
            outs.append(self.run(state=state, n=1))
        return outs
"""
    assert "DONATE" in rules_of(lint_text(src, "m.py"))


def test_donate_resolves_module_functions_by_keyword():
    src = """
from repro_torch.lint import consumes

@consumes("p", "m")
def step(p, g, m):
    return p, m

def train(p, g, m):
    step(p, g, m=m)
    return m
"""
    findings = lint_text(src, "m.py")
    assert rules_of(findings) == ["DONATE"] and findings[0].line == 10


# ---------------------------------------------------------------- KEY-REUSE

@pytest.mark.parametrize("draw", [
    "torch.randn(4, 4)", "torch.rand_like(w)", "torch.randint(0, 9, (4,))",
    "torch.randperm(8)", "torch.bernoulli(w)", "torch.multinomial(w, 2)",
    "w.normal_()", "w.uniform_(-1, 1)", "torch.nn.init.normal_(w)"])
def test_key_reuse_flags_draws_without_generator(draw):
    src = f"import torch\n\ndef init(w, gen):\n    return {draw}\n"
    findings = lint_text(src, "m.py")
    assert rules_of(findings) == ["KEY-REUSE"]
    assert "generator=" in findings[0].message


def test_key_reuse_silent_with_explicit_generator():
    src = """
import torch

def init(w, gen):
    a = torch.randn(4, 4, generator=gen, device=gen.device)
    w.normal_(0.0, 0.02, generator=gen)
    return a, torch.rand_like(w, generator=gen)
"""
    assert lint_text(src, "m.py") == []


@pytest.mark.parametrize("call", ["torch.manual_seed(0)",
                                  "torch.cuda.manual_seed_all(0)"])
def test_key_reuse_flags_global_reseed(call):
    assert rules_of(lint_text(f"import torch\n\ndef f():\n    {call}\n",
                              "m.py")) == ["KEY-REUSE"]


def test_key_reuse_flags_two_generators_from_one_seed():
    src = """
import torch

def init(seed):
    gw = torch.Generator().manual_seed(seed)
    gb = torch.Generator()
    gb.manual_seed(seed)
    return gw, gb
"""
    findings = lint_text(src, "m.py")
    assert rules_of(findings) == ["KEY-REUSE"] and findings[0].line == 7


@pytest.mark.parametrize("body", [
    "    gens = []\n    for k in range(n):\n"
    "        gens.append(torch.Generator().manual_seed(seed * 1000 + k))\n"
    "    return gens\n",
    "    ga = torch.Generator().manual_seed(seed)\n"
    "    gb = torch.Generator().manual_seed(seed + 1)\n    return ga, gb\n",
    "    ga = torch.Generator().manual_seed(seed)\n    seed = seed + 1\n"
    "    gb = torch.Generator().manual_seed(seed)\n    return ga, gb\n",
])
def test_key_reuse_silent_on_distinct_seeds(body):
    src = "import torch\n\ndef init(seed, n):\n" + body
    assert lint_text(src, "m.py") == []


# ------------------------------------------------------------------- KERNEL

KERNEL_MOD = "src/repro_torch/kernels/k/ops.py"
KERNEL_PREAMBLE = """
import torch
from .. import _build
from .ref import k_ref
"""


@pytest.mark.parametrize("handler", [
    "        return k_ref(x)\n", "        pass\n",
    "        return run(x, impl='ref')\n"])
def test_kernel_flags_fallback_around_launch(handler):
    src = KERNEL_PREAMBLE + """
def run(x, impl=None):
    try:
        _build.library("k").k_f32(x.data_ptr())
    except OSError:
""" + handler
    findings = lint_text(src, KERNEL_MOD)
    assert rules_of(findings) == ["KERNEL"]
    assert "falls back" in findings[0].message


def test_kernel_silent_when_the_handler_raises():
    src = KERNEL_PREAMBLE + """
def run(x):
    try:
        _build.library("k").k_f32(x.data_ptr())
    except OSError as e:
        raise RuntimeError("k kernel failed to load") from e
"""
    assert lint_text(src, KERNEL_MOD) == []


def test_kernel_flags_dispatch_on_cuda_availability():
    src = KERNEL_PREAMBLE + """
def run(x):
    if torch.cuda.is_available():
        return _build.library("k").k_f32(x.data_ptr())
    return k_ref(x)
"""
    assert rules_of(lint_text(src, KERNEL_MOD)) == ["KERNEL"]


def test_kernel_silent_on_operand_dispatch_and_outside_kernels():
    operand = KERNEL_PREAMBLE + """
def run(x, impl=None):
    if impl is None:
        impl = "cuda" if x.is_cuda else "ref"
    if impl == "ref":
        return k_ref(x)
    return _build.library("k").k_f32(x.data_ptr())
"""
    assert lint_text(operand, KERNEL_MOD) == []
    elsewhere = "import torch\n\ndef pick():\n" \
                "    return 'cuda' if torch.cuda.is_available() else 'cpu'\n"
    assert lint_text(elsewhere, "src/repro_torch/device.py") == []
    assert lint_text(elsewhere, KERNEL_MOD) == []    # loads no library


# ---------------------------------------------------------- SIM-DETERMINISM

SIM_SOURCES = [
    """
import time

class Sim:
    def run(self, pending: set):
        t0 = time.time()
        out = []
        for ev in pending:
            out.append(ev)
        return out, t0
""",
    """
import random

class Sim:
    def run(self, pending: set, seed: int):
        rng = random.Random(seed)
        out = [rng.random() for _ in sorted(pending)]
        return out, len(pending), random.random(), list(pending)
""",
    """
import datetime

def stamp(xs: frozenset):
    return datetime.datetime.now(), [x for x in xs], sorted(x for x in xs)
""",
]


@pytest.mark.parametrize("src", SIM_SOURCES)
@pytest.mark.parametrize("where", ["sim/executor.py", "hier/runner.py"])
def test_sim_determinism_equals_the_reference(src, where):
    def key(findings):
        return [(f.rule, f.severity, f.line, f.col, f.message, f.context)
                for f in findings]
    got = lint_text(src, f"src/repro_torch/{where}")
    want = jlint.lint_text(src, f"src/repro/{where}")
    assert got and key(got) == key(want)
    assert lint_text(src, "src/repro_torch/serve/engine.py") == []
    # the reference's scope strings do not name the port's paths
    assert jlint.lint_text(src, f"src/repro_torch/{where}") == []


# ------------------------------------------------------- pragmas / baseline

ITEM = """
from repro.lint import hot_path

@hot_path
def tick(x):
    v = x.item(){pragma}
    return v
"""


@pytest.mark.parametrize("pragma,flagged", [
    ("", True),
    ("  # repro-lint: disable=HOST-SYNC -- measured on purpose", False),
    ("  # repro-lint: disable", False),
    ("  # repro-lint: disable=RECOMPILE", True),
])
def test_pragmas_scope_like_the_reference(pragma, flagged):
    src = ITEM.format(pragma=pragma)
    got, want = lint_text(src, "m.py"), jlint.lint_text(src, "m.py")
    assert rules_of(got) == rules_of(want) == \
        (["HOST-SYNC"] if flagged else [])


def test_pragma_standalone_comment_covers_next_statement():
    src = ITEM.format(pragma="").replace(
        "    v = x.item()", "    # repro-lint: disable=HOST-SYNC -- this "
        "sync IS the\n    # measurement boundary (two lines)\n\n"
        "    v = x.item()")
    assert lint_text(src, "m.py") == jlint.lint_text(src, "m.py") == []


def test_fingerprints_equal_for_equal_rule_path_context_and_line():
    src_a = ITEM.format(pragma="")
    src_b = "\n\n\n" + src_a.replace("x.item()", "x.item(  )")
    fa, fb = lint_text(src_a, "m.py")[0], lint_text(src_b, "m.py")[0]
    ja = jlint.lint_text(src_a, "m.py")[0]
    assert fa.line != fb.line
    assert fa.fingerprint() != fb.fingerprint()     # the text differs
    src_b = "\n\n\n" + src_a.replace("x.item()", "x.item()  ")
    fb = lint_text(src_b, "m.py")[0]
    assert fa.fingerprint() == fb.fingerprint() == ja.fingerprint()
    assert (fa.rule, fa.path, fa.line, fa.context, fa.line_text) == \
        (ja.rule, ja.path, ja.line, ja.context, ja.line_text)


def test_baseline_round_trip_count_matching_and_cross_reading(tmp_path):
    findings = lint_text(ITEM.format(pragma=""), "m.py")
    ref_findings = jlint.lint_text(ITEM.format(pragma=""), "m.py")
    for io, fs, other in ((baseline_io, findings, jbaseline),
                          (jbaseline, ref_findings, baseline_io)):
        path = tmp_path / "b.json"
        io.save(path, fs)
        for reader in (io, other):         # the two formats are one
            grand = reader.load(path)
            assert reader.partition(fs, grand) == ([], fs)
            new, old = reader.partition(fs * 2, grand)
            assert len(new) == 1 and len(old) == 1
    assert baseline_io.load(tmp_path / "absent.json") == {}
    (tmp_path / "v.json").write_text(json.dumps({"version": 99}))
    with pytest.raises(ValueError):
        baseline_io.load(tmp_path / "v.json")


def test_json_report_keys_equal_the_reference():
    def keys(obj):
        if isinstance(obj, dict):
            return {k: keys(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [keys(v) for v in obj[:1]]
        return type(obj).__name__
    src = ITEM.format(pragma="")
    got = json.loads(report.render_json(lint_text(src, "a.py"),
                                        lint_text(src, "b.py")))
    want = json.loads(jreport.render_json(jlint.lint_text(src, "a.py"),
                                          jlint.lint_text(src, "b.py")))
    assert keys(got) == keys(want)
    assert report.render_human([], []) == jreport.render_human([], [])
    f = Finding("HOST-SYNC", ERROR, "m.py", 3, 5, "msg", "tick", "x")
    assert f.to_json() == jlint.Finding(*f.__dict__.values()).to_json()


def test_cli_exit_codes_equal_the_reference(tmp_path, capsys):
    files = {
        "bad.py": ITEM.format(pragma=""),
        "clean.py": ITEM.format(pragma="  # repro-lint: disable"),
        "warn.py": "from repro.lint import hot_path\n\n@hot_path\n"
                   "def tick(x):\n    print(x.y)\n",
        "broken.py": "def f(:\n",
    }
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    b = str(tmp_path / "base.json")
    runs = [
        ["bad.py"], ["clean.py"], ["warn.py"], ["warn.py", "--strict"],
        ["broken.py"], ["bad.py", "--select", "RECOMPILE"],
        ["bad.py", "--ignore", "HOST-SYNC"], ["bad.py", "--format", "json"],
        ["bad.py", "--baseline", b, "--write-baseline"],
        ["bad.py", "--baseline", b], ["--list-rules"],
    ]
    for args in runs:
        argv = [str(tmp_path / a) if a.endswith(".py") else a
                for a in args]
        codes = []
        for main in (lint_main, jmain):
            codes.append(main(argv))
            capsys.readouterr()
        assert codes[0] == codes[1], (args, codes)
    assert [lint_main([str(tmp_path / "bad.py")])] == [1]
    assert "HOST-SYNC" in capsys.readouterr().out
    for main in (lint_main, jmain):
        with pytest.raises(SystemExit) as e:
            main(["--format", "xml"])
        assert e.value.code == 2
    capsys.readouterr()


# --------------- the four acceptance injections of tests/test_lint.py

INJECTIONS = {
    "float(loss) in the period loop": ("HOST-SYNC", """
import jax
from repro.lint import hot_path

class Runner:
    @hot_path
    def run_period(self, steps):
        state = self.state
        for r in range(steps):
            state, metrics = self.step_fn(state, self.data.batch(r))
            self.history.append(float(metrics["loss"]))
        return state
""", """
import torch
from repro_torch.lint import hot_path

class Runner:
    @hot_path
    def run_period(self, steps):
        state = self.state
        for r in range(steps):
            state, metrics = self.step_fn(state, self.data.batch(r))
            self.history.append(float(metrics["loss"]))
        return state
"""),
    "a capture or jit in the decode tick": ("RECOMPILE", """
import jax

class Engine:
    def step(self, reqs):
        for req in reqs:
            fn = jax.jit(self.decode_fn)
            out = fn(self.state, req)
        return out
""", """
import torch

class Engine:
    def step(self, reqs):
        for req in reqs:
            fn = torch.cuda.CUDAGraph()
            out = fn.replay()
        return out
"""),
    "a reused key or generator seed": ("KEY-REUSE", """
import jax

def init(seed):
    key = jax.random.PRNGKey(seed)
    w = jax.random.normal(key, (4, 4))
    b = jax.random.normal(key, (4,))
    return w, b
""", """
import torch

def init(seed):
    gw = torch.Generator().manual_seed(seed)
    w = torch.randn(4, 4, generator=gw)
    b = torch.randn(4, generator=torch.Generator().manual_seed(seed))
    return w, b
"""),
    "use after donate or consume": ("DONATE", """
import jax



def train(step, state, batches):
    g = jax.jit(step, donate_argnums=(0,))
    new_state, metrics = g(state, batches[0])
    return state.params, metrics
""", """
from repro_torch.lint import consumes
@consumes("state")
def g(state, batch):
    return state, {}
def train(step, state, batches):
    del step
    new_state, metrics = g(state, batches[0])
    return state.params, metrics
"""),
}


@pytest.mark.parametrize("case", list(INJECTIONS))
def test_acceptance_injections_fire_in_both_linters(case):
    rule, jax_src, torch_src = INJECTIONS[case]
    want = jlint.lint_text(jax_src, "m.py")
    got = lint_text(torch_src, "m.py")
    assert rules_of(want) == rules_of(got) == [rule], (want, got)
    assert want[0].line == got[0].line


# ------------------------------------------------------------- self checks

def test_import_loads_no_torch_jax_or_the_jax_package():
    code = ("import sys, repro_torch.lint, repro_torch.lint.__main__\n"
            "from repro_torch.lint import all_rules\n"
            "assert len(all_rules()) == 6\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'repro', 'numpy'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr


def test_tree_lints_clean_against_the_empty_baseline(capsys):
    base = REPO / ".repro-torch-lint-baseline.json"
    assert json.loads(base.read_text()) == {"findings": [], "version": 1}
    assert lint_main([str(SRC / "repro_torch"), "--baseline",
                      str(base)]) == 0
    assert capsys.readouterr().out.strip() == "clean"
    assert lint_paths([SRC / "repro_torch"]) == []     # warnings too


def _hot(pkg: str) -> set[tuple[str, str]]:
    from repro.lint.engine import build_context as jbuild
    build = build_context if pkg == "repro_torch" else jbuild
    root = SRC / pkg
    out = set()
    for f in sorted(root.rglob("*.py")):
        if "lint" in f.relative_to(root).parts:
            continue
        ctx = build(f.read_text(), f)
        out |= {(f.relative_to(root).as_posix(), i.qualname)
                for i in ctx.hot_functions()}
    return out


def test_the_reference_hot_functions_are_marked_in_the_port():
    port = _hot("repro_torch")
    assert len(port) == 14 and port == _hot("repro")
    runner = build_context((SRC / "repro_torch/runtime/runner.py")
                           .read_text(), "runner.py")
    consumed = {i.qualname for i in runner.functions if any(
        getattr(getattr(d, "func", None), "id", "") == "consumes"
        for d in i.node.decorator_list)}
    assert consumed == {"Runner.run", "Runner._run_per_step",
                        "Runner._run_fused"}


def test_registry_and_markers():
    assert set(all_rules()) == {"HOST-SYNC", "RECOMPILE", "DONATE",
                                "KEY-REUSE", "KERNEL", "SIM-DETERMINISM"}

    @hot_path
    def f(x):
        return x + 1

    @consumes("state")
    def g(state):
        return state

    assert f(1) == 2 and f.__repro_hot_path__ is True
    assert g(3) == 3 and g.__repro_consumes__ == ("state",)
    assert f.__name__ == "f" and g.__name__ == "g"
