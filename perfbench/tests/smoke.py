"""A cell shrunk to a size the CPU runs in seconds: the cell's own files
with every width and count cut down, for the tests."""

import json
from pathlib import Path

from perfbench import bench

PB = Path(__file__).resolve().parents[1]
B = json.loads((PB.parent / "BENCHMARK.json").read_text())


def smoke_files(cell: str, dtype: str):
    w = next(x for x in B["workloads"] if x["name"] == cell)
    conf = next(c for c in B["configs"] if c["name"] == w["config"])
    cfg = json.loads((PB.parent / conf["file"]).read_text())
    cfg.update(hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, head_dim=32, intermediate_size=512,
               vocab_size=512, torch_dtype=dtype)
    if "workers" in cfg:
        cfg["workers"] = 2
    mix = json.loads((PB / "traffic" / f"{w['traffic']}.json").read_text())
    if mix["loop"] == "train":
        mix["job"].update(batch_per_worker=2, seq=16)
    else:
        # the cell's logit scale (initializer_range x sqrt(hidden_size),
        # ~1.1) and a vocabulary large enough for near ties
        cfg.update(vocab_size=8192, initializer_range=0.1)
        mix.update(clients=3, warmup_completions=3, drain_s=60)
        mix["engine"].update(slots=4, max_seq=96)
        mix["prompt"] = {"dist": "lognormal", "median": 16, "sigma": 0.8,
                         "min": 4, "max": 48}
        mix["output"] = {"dist": "uniform", "min": 2, "max": 32}
        mix["check"] = {"served_tokens": 200, "max_requests": 12}
    return cfg, mix


def smoke_run(cell: str, seed: int, dtype: str, seconds: float = 2.0):
    """One run of the shrunk cell on the CPU; returns the run."""
    cfg, mix = smoke_files(cell, dtype)
    run = bench.Run(cell, seed, seconds, False, device="cpu", config=cfg,
                    traffic=mix)
    run.result_line = run.go()
    return run
