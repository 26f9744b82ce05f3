"""The plain reference against the port at smoke sizes on the CPU: the
same logits from the same weights, and the harness's checks of a
float32 run agreeing to rounding, training and serving."""

import pytest
import torch

from perfbench import reference
from perfbench.models import dense_decoder
from perfbench.tests.smoke import smoke_files, smoke_run
from perfbench.weights import dense_leaves, dense_params, flatten

CELLS = ["granite-train-dreamddp", "granite-train-int8", "phi4-chat-c64",
         "phi4-docqa-c8"]


@pytest.mark.parametrize("cell", ["granite-train-dreamddp", "phi4-chat-c64"])
def test_logits_equal_the_ports(cell):
    cfg, _ = smoke_files(cell, "float32")
    model, m = dense_decoder.program_model(cfg)
    params = dense_params(m, 3, "cpu", torch.float32)
    tokens = torch.randint(0, m["vocab"], (2, 24),
                           generator=torch.Generator().manual_seed(0))
    want = model.apply(params, tokens)
    got = reference.forward_logits(flatten(params), tokens, m)
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)
    seqs = [(tokens[0].tolist(), [5, 17, 23])]
    served = reference.served_logits(m, 3, "cpu", seqs)[0]
    assert torch.allclose(served, want[0, [5, 17, 23]], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("cell", ["granite-train-dreamddp",
                                  "granite-train-int8"])
@pytest.mark.parametrize("smoke", [False, True], ids=["cell", "smoke"])
def test_plan_is_the_papers(cell, smoke):
    """The units each phase syncs, as the paper's method gives them
    (:mod:`perfbench.plan`), are the program's plan, at the cell's sizes
    and at smoke sizes (the plan needs no weights)."""
    from repro_torch.api import Session

    from perfbench import bench, plan
    from perfbench.loops import train
    cfg, mix = smoke_files(cell, "bfloat16") if smoke else (None, None)
    run = bench.Run(cell, 7, 1.0, False, device="cpu", config=cfg,
                    traffic=mix)
    model, m = run.model()
    job, ref_job = train.job_config(run)
    want = [tuple(u) for u in Session(job, model=model,
                                      device="cpu").plan.phase_units]
    assert plan.phase_units(m, ref_job, ref_job["workers"]) == want


def test_leaves_are_the_ports():
    cfg, _ = smoke_files("phi4-chat-c64", "bfloat16")
    _, m = dense_decoder.program_model(cfg)
    assert [p for p, _, _ in dense_leaves(m)][0] == "embed.table"


@pytest.mark.parametrize("cell", CELLS)
def test_float32_run_agrees(cell):
    """In float32 the program and the reference differ by summation
    order alone, far inside every limit."""
    run = smoke_run(cell, 2**31 + 11, "float32")
    line = run.result_line
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    for name, c in line["checks"].items():
        assert c["value"] <= 1e-3 * max(1.0, c["limit"]), name
    assert list(line)[-1] == "checks"
