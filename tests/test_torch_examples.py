"""The port's examples (``examples/torch_*.py``) run on the CPU.

Each example is run in this process with ``--device cpu`` and small
arguments, and what it prints is checked for the lines its counterpart in
``examples/`` prints.  Where an example fixes its size in module
constants (quickstart's ``W``/``H``/``STEPS``, train_100m's
``CFG_100M``), the test loads it under another name than ``__main__``,
shrinks the constants in its globals and calls its ``main()``.  None
imports ``repro`` or ``jax``: checked on the source text.
"""

import dataclasses

import math
import re
import runpy
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _run(name, argv, capsys, **constants):
    """Run ``examples/<name>`` with ``argv``, its module constants replaced
    by ``constants``; return what it printed."""
    path = EXAMPLES / name
    old = sys.argv
    sys.argv = [str(path), *argv]
    try:
        if constants:
            main = runpy.run_path(str(path), run_name="example")["main"]
            main.__globals__.update(constants)
            main()
        else:
            runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = old
    return capsys.readouterr().out


@pytest.mark.parametrize("name", ["torch_quickstart.py",
                                  "torch_serve_batch.py",
                                  "torch_train_100m.py",
                                  "torch_geo_distributed.py",
                                  "torch_schedule_explorer.py"])
def test_example_imports_only_the_port(name):
    text = (EXAMPLES / name).read_text()
    imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", text, re.M)
    assert any(m.startswith("repro_torch") for m in imports)
    assert not any(m.split(".")[0] in ("repro", "jax") for m in imports)
    assert (EXAMPLES / name.removeprefix("torch_")).exists()


def test_quickstart(capsys):
    out = _run("torch_quickstart.py", ["--device", "cpu"], capsys,
               W=2, STEPS=4)
    assert "registered strategies: " in out and "dreamddp" in out
    assert re.search(r"model: granite-smoke, [\d.]+M params", out)
    assert "phase 4: sync units" in out
    m = re.search(r"loss ([\d.]+) -> ([\d.]+); divergence", out)
    assert m and all(math.isfinite(float(x)) for x in m.groups())


def test_serve_batch(capsys):
    out = _run("torch_serve_batch.py", ["--device", "cpu", "--gen", "4"],
               capsys)
    assert out.count("done: req") == 4
    assert re.search(r"4 requests, \d+ tokens, [\d.]+ decode tok/s", out)


def test_train_100m(capsys, tmp_path):
    path = EXAMPLES / "torch_train_100m.py"
    cfg = runpy.run_path(str(path), run_name="example")["CFG_100M"]
    out = _run("torch_train_100m.py",
               ["--device", "cpu", "--steps", "2", "--workers", "2",
                "--seq", "16", "--batch-per-worker", "1",
                "--ckpt-dir", str(tmp_path)],
               capsys, CFG_100M=dataclasses.replace(
                   cfg, n_layers=2, d_model=64, d_ff=256))
    assert "plan:" in out
    m = re.search(r"loss ([\d.]+) -> ([\d.]+) \(floor ~([\d.]+)\); "
                  r"(\d+) ms/step", out)
    assert m and all(math.isfinite(float(x)) for x in m.groups())


def test_geo_distributed(capsys):
    out = _run("torch_geo_distributed.py", ["--device", "cpu"], capsys)
    rows = [ln for ln in out.splitlines() if re.match(r"\s+\d\.?\d*e\+", ln)]
    assert len(rows) == 5
    s1 = [float(r.split()[-2]) for r in rows]
    assert all(x > 1.0 for x in s1)              # faster than ASC-WFBP
    assert "S1 = speedup vs ASC-WFBP" in out


def test_schedule_explorer(capsys):
    out = _run("torch_schedule_explorer.py",
               ["--device", "cpu", "--H", "3"], capsys)
    assert out.startswith("qwen3-1.7b: ")
    assert out.count("  BP  |") == 3 and out.count("  COMM|") == 3


def test_examples_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        old = sys.argv
        sys.argv = ["torch_schedule_explorer.py"]
        try:
            runpy.run_path(str(EXAMPLES / "torch_schedule_explorer.py"),
                           run_name="__main__")
        finally:
            sys.argv = old
