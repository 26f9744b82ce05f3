"""The benchmark files of the MoE training cell and the open-loop chat
cell: the configuration keeps the published sizes and lists its cuts,
the checks and mixes hold what their loops read, and each cell, shrunk
to a size the CPU runs in seconds, is correct when sound and not correct
with a fault planted in the program (the MoE cell in float32, where the
program and the reference differ by the order of sums alone)."""

import json
import statistics
from pathlib import Path

import pytest
import torch

from perfbench import bench, moe_costs, moe_reference
from perfbench.models import moe_decoder
from perfbench.moe_weights import moe_leaves
from perfbench.tests.smoke import smoke_files

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "perfbench"
B = json.loads((ROOT / "BENCHMARK.json").read_text())
MOE, CHAT = "moonlight-train-dreamddp", "phi4-chat-poisson"
SEED = 2**31 + 101


def _cell_files(cell):
    w = next(x for x in B["workloads"] if x["name"] == cell)
    conf = next(c for c in B["configs"] if c["name"] == w["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((PB / "traffic" / f"{w['traffic']}.json").read_text())
    return conf, cfg, mix


def moe_files(dtype: str):
    """The MoE cell shrunk: 1 dense + 2 MoE layers of width 64, 2 of 8
    experts held (experts 1-2), top-2, 2 workers x 2 x 16 tokens."""
    _, cfg, mix = _cell_files(MOE)
    cfg.update(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
               kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
               v_head_dim=16, intermediate_size=96, moe_intermediate_size=32,
               n_routed_experts=2, num_experts_per_tok=2, vocab_size=256,
               torch_dtype=dtype, workers=2, experts_held_first=1)
    cfg["published"] = dict(cfg["published"], n_routed_experts=8)
    mix["job"].update(batch_per_worker=2, seq=16)
    return cfg, mix


def chat_files():
    """The chat cell shrunk as the closed chat cell is
    (:func:`perfbench.tests.smoke.smoke_files`), at 4 arrivals a second,
    which the CPU serves with room."""
    cfg, small = smoke_files("phi4-chat-c64", "bfloat16")
    _, _, mix = _cell_files(CHAT)
    for key in ("clients", "warmup_completions", "drain_s", "engine",
                "prompt", "output", "check"):
        mix[key] = small[key]
    mix["rate"] = 4.0
    return cfg, mix


def run_moe(dtype="float32"):
    cfg, mix = moe_files(dtype)
    run = bench.Run(MOE, SEED, 1.0, False, device="cpu", config=cfg,
                    traffic=mix)
    run.result_line = run.go()
    return run


def run_chat():
    """On one intra-op thread: arrivals keep their clock whatever else
    loads the CPU, so a loaded CPU's oversubscribed threads would queue
    every request past the drain (the tiny model gains nothing from
    more threads)."""
    cfg, mix = chat_files()
    run = bench.Run(CHAT, SEED, 3.0, False, device="cpu", config=cfg,
                    traffic=mix)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run.result_line = run.go()
    finally:
        torch.set_num_threads(threads)
    return run


# ------------------------------------------------------------------ files

def test_the_configuration_keeps_the_published_sizes():
    """Every published size but the four cuts, each cut listed with its
    published value; no width is cut; the program's tree at these sizes
    is the one the benchmark draws (a ~970M-parameter worker)."""
    conf, cfg, _ = _cell_files(MOE)
    assert conf["reduced"] == cfg["reduced"] == [
        "num_hidden_layers", "n_routed_experts", "vocab_size", "workers"]
    assert cfg["published"] == {"num_hidden_layers": 27,
                                "n_routed_experts": 64,
                                "vocab_size": 163840, "workers": 8}
    assert (cfg["hidden_size"], cfg["moe_intermediate_size"],
            cfg["intermediate_size"], cfg["kv_lora_rank"],
            cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
            cfg["v_head_dim"], cfg["num_attention_heads"],
            cfg["num_experts_per_tok"], cfg["n_shared_experts"]) == \
        (2048, 1408, 11264, 512, 128, 64, 128, 16, 6, 2)
    assert cfg["q_lora_rank"] is None and cfg["rms_norm_eps"] == 1e-5
    assert set(cfg["cuts"]) == set(cfg["reduced"]) and cfg["deployment"]
    # an eighth of the vocabulary, 8 experts held, a whole period
    assert cfg["vocab_size"] * 8 == cfg["published"]["vocab_size"]
    assert cfg["n_routed_experts"] * 8 == cfg["published"]["n_routed_experts"]
    model, m = moe_decoder.program_model(cfg)
    n = sum(torch.Size(s).numel() for _, s, _, _ in moe_leaves(m))
    assert n == model.param_count() and 960e6 < n < 980e6


def test_checks_and_mixes_hold_what_the_loops_read():
    limits = json.loads((PB / "checks" / f"{MOE}.json").read_text())
    assert set(limits) == {"plan_gap", "grad_gap", "change_gap"}
    assert limits["plan_gap"]["limit"] == 0
    assert all(v["limit"] > 0 and v["from"] for k, v in limits.items()
               if k != "plan_gap")
    chat = json.loads((PB / "checks" / f"{CHAT}.json").read_text())
    closed = json.loads((PB / "checks" / "phi4-chat-c64.json").read_text())
    assert chat["served_logit_gap"]["limit"] == \
        closed["served_logit_gap"]["limit"]
    _, _, mix = _cell_files(CHAT)
    _, _, c64 = _cell_files("phi4-chat-c64")
    for key in ("engine", "prompt", "output", "check", "clients"):
        assert mix[key] == c64[key], key
    assert mix["loop"] == "open_loop"
    assert mix["rate"] == pytest.approx(0.8 * mix["knee"], abs=0.25)
    _, _, train = _cell_files(MOE)
    _, _, h5 = _cell_files("granite-train-dreamddp")
    for key in ("algo", "sync", "period", "lr", "warmup_steps",
                "decay_steps", "min_lr_ratio", "weight_decay", "beta1",
                "beta2", "eps", "grad_clip", "plan"):
        assert train["job"][key] == h5["job"][key], key
    assert (train["job"]["batch_per_worker"], train["job"]["seq"]) == \
        (2, 4096)


def test_active_flops_of_the_cell():
    """~1.23 GFLOP a token forward (8 MoE layers of ~117M, the dense
    208M, the head 84M): ~121 TFLOP a step of 4 x 2 x 4096 tokens."""
    _, cfg, mix = _cell_files(MOE)
    m = moe_decoder.sizes(cfg)
    flops = moe_costs.train_flops_per_step(m, 4, 2, 4096)
    assert 120e12 < flops < 122e12


# --------------------------------------------------------------- the cells

def test_sound_moe_run_is_correct():
    """float32: the checks read the order of sums alone, far inside every
    limit; every routed row of the checked period is counted."""
    run = run_moe()
    line = run.result_line
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    for name, c in line["checks"].items():
        assert c["value"] <= 1e-3 * max(1.0, c["limit"]), name
    assert run.info["eager_routed_rows"] > 0
    assert bench.reader("moe_train.mfu")(run.values) > 0
    load = bench.reader("moe.expert_load_max_over_mean")(run.values)
    assert load >= 1.0


def test_moe_bf16_run_reports():
    line = run_moe("bfloat16").result_line
    assert line["failed"] == 0 and set(line["checks"]) == {
        "plan_gap", "grad_gap", "change_gap"}
    assert line["checks"]["plan_gap"]["value"] == 0


def _no_update(monkeypatch):
    from repro_torch.optim import optimizers
    monkeypatch.setattr(optimizers, "fused_adamw", lambda *a, **k: None)


def _no_exchange(monkeypatch):
    from repro_torch.core import sync_policies

    def keep(self, params, ef, outer, unit_ids, layout):
        return params, ef, outer
    monkeypatch.setattr(sync_policies.SyncPolicy, "apply", keep)


@pytest.mark.parametrize("fault", [_no_update, _no_exchange],
                         ids=["unchanged", "no_exchange"])
def test_moe_fault_is_caught(fault, monkeypatch):
    fault(monkeypatch)
    assert not run_moe().result_line["correct"]


def test_moe_control_is_not_correct():
    run = run_moe()
    c = run.values["train_check"]

    def both(**kw):
        first = moe_reference.train_reference(c["m"], c["job"], SEED,
                                              c["first_rows"], "cpu",
                                              steps=1, **kw)
        return first, moe_reference.train_reference(c["m"], c["job"], SEED,
                                                    c["rows"], "cpu", **kw)
    first, ref = both()
    ctl_first, ctl = both(quant="fp8")
    got = bench.train_numbers(ctl["phase_units"], ctl_first["grad_norms"],
                              ctl["losses"], ctl["moment"], ctl["change"],
                              first, ref)
    assert any(v > run.limits[k]["limit"] for k, v in got.items()
               if k in run.limits), got


def test_sound_chat_run_is_correct():
    run = run_chat()
    line = run.result_line
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert len(run.values["queue_s"]) == line["attempted"]
    assert bench.reader("serve.queue_wait_p95_ms")(run.values) >= 0
    assert bench.reader("tpot_p95_ms")(run.values) > 0
    # requests are timed from their scheduled arrivals, which are spread
    # over the window
    assert run.info["offered"] == line["attempted"]


def test_altered_token_is_caught_in_the_open_loop(monkeypatch):
    from repro_torch.serve import scheduler
    real = scheduler.RequestState.emit

    def emit(self, token):
        if len(self.tokens) == 1:
            token = (token + 1) % 8192
        real(self, token)
    monkeypatch.setattr(scheduler.RequestState, "emit", emit)
    assert not run_chat().result_line["correct"]


def test_arrivals_repeat_by_seed_and_follow_the_rate():
    from perfbench.loops.open_loop import Arrivals
    _, _, mix = _cell_files(CHAT)
    a, b = (Arrivals(mix, 1000, SEED, 10.0) for _ in range(2))
    gaps = [a.next_gap() for _ in range(40000)]
    assert gaps == [b.next_gap() for _ in range(40000)]
    # exponential gaps (each bound about 4 standard errors): the mean
    # 1 / rate, 36.8% of the gaps above the mean, 5.0% above 3 means
    assert abs(sum(gaps) / len(gaps) - 0.1) < 0.002
    assert abs(sum(g > 0.1 for g in gaps) / 40000 - 0.3679) < 0.01
    assert abs(sum(g > 0.3 for g in gaps) / 40000 - 0.0498) < 0.005
    # a Poisson count: a 45-s window at 6.8 offers 306 requests on
    # average, with a standard deviation of sqrt(306) = 17.5 over seeds
    counts = []
    for seed in range(1, 41):
        c = Arrivals(mix, 1000, seed, 6.8)
        t, n = 0.0, 0
        while t < 45.0:
            t += c.next_gap()
            n += 1
        counts.append(n - 1)
    assert abs(statistics.mean(counts) - 306) < 11
    assert 11 < statistics.pstdev(counts) < 25
    assert [a.next()[1] for _ in range(64)] == [b.next()[1]
                                                for _ in range(64)]
