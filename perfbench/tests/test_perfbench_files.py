"""Every file the benchmark finds by name loads, and BENCHMARK.json keeps
to the benchmark's contract: names, units, keys, bounds, the files each
entry names."""

import json
import re
from pathlib import Path

import pytest

from perfbench import bench
from perfbench.models import dense_decoder

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "perfbench"
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in B["workloads"]]
METRICS = B["end_to_end"] + B["per_layer"]


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert B["paths"] == ["perfbench"]
    assert len(B["command"]) <= 32
    assert all(TEXT.match(w) for w in B["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", B["configs"] + B["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer"):
        if key in entry:
            assert TEXT.match(entry[key]), key
    if "file" in entry:
        assert TEXT.match(entry["source"])


def test_unique_names():
    for group in (B["configs"], B["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("conf", B["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    path = ROOT / conf["file"]
    assert path.parent == PB / "configs"
    cfg = json.loads(path.read_text())
    assert cfg["name"] == conf["name"] and cfg["source"] == conf["source"]
    assert cfg["reduced"] == conf["reduced"]
    assert set(cfg.get("published", {})) == set(conf["reduced"])
    for key in conf["reduced"]:
        assert NAME.match(key) and key in cfg
        assert not key.endswith(("_dim", "_rank", "_size"))
    dense_decoder.sizes(cfg)
    assert any(w["config"] == conf["name"] for w in B["workloads"])


@pytest.mark.parametrize("cell", B["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    mix = json.loads((PB / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    assert (PB / "loops" / f"{mix['loop']}.py").exists()
    limits = json.loads((PB / "checks" / f"{cell['name']}.json").read_text())
    want = {"train": {"plan_gap", "grad_gap", "change_gap"},
            "closed_loop": {"served_logit_gap"}}[mix["loop"]]
    assert set(limits) == want
    for name, v in limits.items():
        # an exact comparison has the limit 0
        assert v["limit"] == 0 if name == "plan_gap" else v["limit"] > 0
    e2e = bench.cell_metrics(B, cell["name"], "end_to_end")
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert bench.cell_metrics(B, cell["name"], "per_layer")


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric(metric):
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric in B["end_to_end"]:
        allowed |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in {m["name"] for m in B["end_to_end"]}
        assert TEXT.match(metric["layer"])
        assert metric["workloads"]
        for cell in metric["workloads"]:
            assert metric["moves"] in {
                m["name"] for m in bench.cell_metrics(B, cell, "end_to_end")}
    assert set(metric) <= allowed
    assert set(metric.get("workloads", [])) <= set(CELLS)
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"
    assert callable(bench.reader(metric["name"]))


def test_one_layer_one_name():
    by_layer = {}
    for m in B["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_kernel_rooflines_have_a_step_share():
    """Each kernel's roofline moves an end-to-end metric that a whole
    step's share of the peak (``mfu`` in its name) also moves."""
    moved_by_mfu = {m["moves"] for m in B["per_layer"] if "mfu" in m["name"]}
    for m in B["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["moves"] in moved_by_mfu


def test_readers_read_nothing_from_nothing():
    for m in METRICS:
        assert bench.reader(m["name"])({}) is None


def test_roofline_reader_reads_bound_over_device_time():
    """A slice whose paged launches took twice their byte time reads 50%;
    launches of other kernels do not count; no launch reads nothing."""
    from perfbench.costs import HBM_BYTES_PER_S
    kernels = [("paged_attention_kernel<bf16>", 0.0, 1500.0),
               ("void gemm", 1500.0, 9000.0),
               ("paged_attention_kernel<bf16>", 9000.0, 9500.0)]
    m = {"n_layers": 1, "n_heads": 1, "n_kv_heads": 1, "head_dim": 1}
    read = bench.reader("paged_attention_roofline")
    # one lane at 2^29 keys: 4 bytes a key, 2^27 table entries of 4 bytes
    v = {"model": m, "kernels": kernels,
         "slice": {"kv_lens": [2**29], "page_size": 4}}
    nbytes = 4 + 4 * 2**29 + 4 * 2**27 + 4
    assert abs(read(v) - 100.0 * (nbytes / HBM_BYTES_PER_S) / 2e-3) < 1e-9
    assert bench.reader("flash_attention_roofline")(v) is None
    v["kernels"] = kernels[1:2]
    assert read(v) is None


def test_breakdown_classes_come_from_the_readers():
    """The breakdown names a hand-written kernel by the name keys its
    roofline reader holds, and any other operation by its kind."""
    from perfbench import costs
    keys = {"paged_attention": bench.metric_module(
        "paged_attention_roofline").KERNELS}
    assert costs.kernel_class("paged_attention_kernel<bf16>", keys) \
        == "paged_attention"
    assert costs.kernel_class("paged_attention_kernel<bf16>", {}) \
        == "other elementwise"
    assert costs.kernel_class("sm90_xmma_gemm", keys) == "matmul"
