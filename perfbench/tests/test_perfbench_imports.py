"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level name (``repro_torch`` is not ``repro``), and the
reference and the yardstick import nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
YARDSTICK = ("reference.py", "weights.py", "costs.py", "traffic.py")


def imported(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_sources_name_no_forbidden_module():
    for path in PB.rglob("*.py"):
        assert not imported(path) & FORBIDDEN, path


def test_yardstick_imports_nothing_of_the_program():
    for name in YARDSTICK:
        assert "repro_torch" not in imported(PB / name), name


SCRIPT = """
import json, sys
sys.path.insert(0, {src!r}); sys.path.insert(0, {root!r})
import perfbench.run, perfbench.calibrate
from perfbench import bench
from perfbench.tests.smoke import smoke_run
for cell in ("granite-train-dreamddp", "phi4-chat-c64"):
    smoke_run(cell, 5, "bfloat16")
for m in json.load(open({bench!r}))["per_layer"]:
    bench.reader(m["name"])
print(json.dumps(sorted(sys.modules)))
"""


def test_a_run_loads_no_forbidden_module():
    code = SCRIPT.format(src=str(ROOT / "src"), root=str(ROOT),
                         bench=str(ROOT / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch" in mods
    assert not {m for m in mods if m.split(".")[0] in FORBIDDEN}
