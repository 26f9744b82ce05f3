"""One run of one cell: what ``perfbench.run`` drives.

Everything is found by name.  ``BENCHMARK.json`` names the cell's
configuration file and traffic mix; the configuration's ``builder``
names the module under ``perfbench/models/`` that builds the program's
model; the mix's ``loop`` names the module under ``perfbench/loops/``
that drives it; ``perfbench/checks/<cell>.json`` holds the limits of
the numbers the cell's check compares; each metric is read by
``perfbench/metrics/<metric name>.py``.  A new configuration, mix,
metric or cell is new files and entries, and no edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path

import torch

from . import trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: an end-to-end metric without ``workloads`` is
    every cell's; a per-layer metric lists its cells."""
    if kind == "end_to_end":
        return [x for x in bench["end_to_end"]
                if cell in x.get("workloads", [cell])]
    return [x for x in bench["per_layer"] if cell in x["workloads"]]


def metric_module(name: str):
    """``perfbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """``perfbench/metrics/<name>.py``'s ``read``."""
    return metric_module(name).read


def p95(xs: list[float]) -> float:
    """The 95th percentile, interpolated between order statistics."""
    if len(xs) == 1:
        return xs[0]
    return statistics.quantiles(xs, n=20, method="inclusive")[18]


class Run:
    """One run's inputs, and what its loop records for the metrics and
    the check."""

    def __init__(self, cell: str, seed: int, seconds: float, trace_on: bool,
                 *, device: str = "cuda", t0: float | None = None,
                 config: dict | None = None, traffic: dict | None = None):
        """``config`` and ``traffic`` stand in for the cell's files (the
        tests' shrunk cells)."""
        self.bench = load_json(ROOT / "BENCHMARK.json")
        self.cell = next(w for w in self.bench["workloads"]
                         if w["name"] == cell)
        conf = next(c for c in self.bench["configs"]
                    if c["name"] == self.cell["config"])
        self.config = config or load_json(ROOT / conf["file"])
        self.traffic = traffic or load_json(
            HERE / "traffic" / f"{self.cell['traffic']}.json")
        self.limits = load_json(HERE / "checks" / f"{cell}.json")
        self.seed, self.seconds, self.trace = seed, seconds, trace_on
        self.device = device
        self.t0 = time.perf_counter() if t0 is None else t0
        self.values: dict = {}
        self.checks: list[tuple[str, float, float]] = []
        self.attempted = self.failed = 0
        self.memory_peak = 0
        self.breakdown = None
        self.marks: list[tuple[str, float]] = []
        self.info: dict[str, float] = {}
        self._w0 = None

    # ------------------------------------------------------ for the loops
    def model(self):
        builder = importlib.import_module(
            f"perfbench.models.{self.config['builder']}")
        return builder.program_model(self.config)

    def mark(self, label: str) -> None:
        """Note the seconds since the process started, for the log."""
        self._sync()
        self.marks.append((label, time.perf_counter() - self.t0))

    def _sync(self) -> None:
        if self.device == "cuda":
            torch.cuda.synchronize()

    def start_window(self) -> None:
        self._sync()
        self._w0 = time.perf_counter()
        self.values["setup_s"] = self._w0 - self.t0

    def elapsed(self) -> float:
        return time.perf_counter() - self._w0

    def end_window(self) -> None:
        self._sync()
        self.values["window_s"] = self.elapsed()

    def profile(self, fn) -> None:
        """Profile ``fn()``; the breakdown classes the device operations
        by the kernel names of the cell's roofline readers (``KERNELS``)
        and then by kind."""
        classes = {}
        for meta in cell_metrics(self.bench, self.cell["name"], "per_layer"):
            mod = metric_module(meta["name"])
            if hasattr(mod, "KERNELS"):
                classes[meta["name"].removesuffix("_roofline")] = mod.KERNELS
        res = trace.profile_slice(fn, classes)
        self.values.update(kernels=res["kernels"], busy_s=res["busy_s"],
                           trace_window_s=res["window_s"])
        self.breakdown = res["breakdown"]

    def read_memory(self) -> None:
        if self.device == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated()

    def check(self, name: str, value: float) -> None:
        self.checks.append((name, value, self.limits[name]["limit"]))

    def compare_train(self, units, grad, losses, moment, change, first,
                      ref) -> None:
        """The training numbers the cell's limits name are checked; the
        others are logged."""
        got = train_numbers(units, grad, losses, moment, change, first, ref)
        for name, value in got.items():
            if name in self.limits:
                self.check(name, value)
            else:
                self.info[name] = value

    # ----------------------------------------------------------- the run
    def go(self) -> dict:
        loop = importlib.import_module(
            f"perfbench.loops.{self.traffic['loop']}")
        loop.drive(self)
        return self.result()

    def result(self) -> dict:
        kind = "per_layer" if self.trace else "end_to_end"
        metrics = {}
        for meta in cell_metrics(self.bench, self.cell["name"], kind):
            value = reader(meta["name"])(self.values)
            if value is None:
                if kind == "end_to_end":
                    raise RuntimeError(f"{meta['name']} read nothing")
                continue
            metrics[meta["name"]] = {"value": value, "unit": meta["unit"]}
        correct = bool(self.checks) and self.failed == 0 and all(
            math.isfinite(v) and v <= lim for _, v, lim in self.checks)
        device = {"platform": "gpu" if self.device == "cuda" else "cpu",
                  "kind": torch.cuda.get_device_name()
                  if self.device == "cuda" else "cpu",
                  "count": self.cell["chips"],
                  "memory_peak_bytes": self.memory_peak}
        if self.trace:
            device.update(busy_s=self.values["busy_s"],
                          window_s=self.values["trace_window_s"])
        out = {"correct": correct, "attempted": self.attempted,
               "failed": self.failed, "metrics": metrics, "device": device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["checks"] = {n: {"value": v, "limit": lim}
                         for n, v, lim in self.checks}
        return out


def train_numbers(units, grad, losses, moment, change, first, ref) -> dict:
    """The training check's numbers against the reference's first step
    (``first``) and period (``ref``): ``plan_gap``, the phase-unit
    memberships in which the program's plan and the paper's differ; by
    the worst leaf, the gap between the norms of the first clipped
    gradient; the widest relative gap of the period's losses; by the
    worst leaf, the gap between the norms of AdamW's first moment and of
    the change after the period.  A leaf's gap is over the reference's
    norm of that leaf or of the median leaf, whichever is larger.  A leaf whose
    reference gradient is under a thousandth of the median leaf's is
    left out of the change (Adam moves it by round-off alone)."""
    g_med = statistics.median(ref["grad_norms"].values())
    moved = {p for p, g in ref["grad_norms"].items() if g >= 1e-3 * g_med}
    want = ref["phase_units"]
    return {
        "plan_gap": float(sum(len(set(a) ^ set(b)) for a, b in
                              zip(units, want, strict=True))
                          if len(units) == len(want) else math.inf),
        "grad_gap": worst_leaf(grad, first["grad_norms"]),
        "loss_gap": max(abs(a - b) / abs(b) for a, b in
                        zip(losses, ref["losses"], strict=True)),
        "moment_gap": worst_leaf(moment, ref["moment"]),
        "change_gap": worst_leaf({p: change[p] for p in moved},
                                 {p: ref["change"][p] for p in moved}),
    }


def worst_leaf(got: dict, want: dict) -> float:
    med = statistics.median(want.values())
    return max(abs(got[p] - w) / max(w, med) for p, w in want.items())


def forbidden_modules() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process,
    compared by whole top-level name."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
