"""A run with the timed path broken underneath comes out as not correct.

Each test drives the whole of a shrunk cell on the CPU (everything but
the look for a card) with one fault planted in the program: a step that
leaves the state unchanged, half of each worker's rows left out with the
mean taken over the rest, the exchange between workers left out, a plan
that syncs other units than the paper's, a token altered where the
engine produces it.  The cell's own limits judge it,
and a sound run of the same cell comes out correct.  The control, the
reference in float8 put in the program's place, comes out as not
correct in a training cell at this size; in a serving cell it departs
from the program here, and fails the limit at the cell's own size on
the card (the ``gpu`` test)."""

import dataclasses

import pytest
import torch

from perfbench import bench, reference
from perfbench.tests.smoke import smoke_files, smoke_run

TRAIN = ["granite-train-dreamddp", "granite-train-int8"]
SERVE = ["phi4-chat-c64", "phi4-docqa-c8"]
SEED = 2**31 + 101


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_sound_run_is_correct(cell):
    assert smoke_run(cell, SEED, "bfloat16").result_line["correct"]


def _no_update(monkeypatch):
    from repro_torch.optim import optimizers
    monkeypatch.setattr(optimizers, "fused_adamw", lambda *a, **k: None)


def _half_batch(monkeypatch):
    from repro_torch.runtime import step
    real = step.per_worker_grads

    def half(model, params, batch, **kw):
        rows = next(iter(batch.values())).shape[1] // 2
        return real(model, params, {k: v[:, :rows] for k, v in
                                    batch.items()}, **kw)
    monkeypatch.setattr(step, "per_worker_grads", half)


def _no_exchange(monkeypatch):
    from repro_torch.core import sync_policies

    def keep(self, params, ef, outer, unit_ids, layout):
        return params, ef, outer
    for cls in (sync_policies.SyncPolicy, sync_policies.Int8EFSync):
        monkeypatch.setattr(cls, "apply", keep)


def _other_plan(monkeypatch):
    from repro_torch.api import strategies
    real = strategies.plan_from_partition

    def shifted(algo, profile, H, result, fills, **kw):
        p = real(algo, profile, H, result, fills, **kw)
        units = p.phase_units
        return dataclasses.replace(p, phase_units=units[1:] + units[:1],
                                   fill_units=p.fill_units[1:]
                                   + p.fill_units[:1])
    monkeypatch.setattr(strategies, "plan_from_partition", shifted)


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", [_no_update, _half_batch, _no_exchange,
                                   _other_plan],
                         ids=["unchanged", "half_batch", "no_exchange",
                              "other_plan"])
def test_training_fault_is_caught(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert not smoke_run(cell, SEED, "bfloat16").result_line["correct"]


@pytest.mark.parametrize("cell", SERVE)
def test_altered_token_is_caught(cell, monkeypatch):
    from repro_torch.serve import scheduler
    real = scheduler.RequestState.emit

    def emit(self, token):
        if len(self.tokens) == 1:
            token = (token + 1) % 8192
        real(self, token)
    monkeypatch.setattr(scheduler.RequestState, "emit", emit)
    assert not smoke_run(cell, SEED, "bfloat16").result_line["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_training_control_is_not_correct(cell):
    run = smoke_run(cell, SEED, "bfloat16")
    c = run.values["train_check"]
    def both(**kw):
        first = reference.train_reference(c["m"], c["job"], SEED,
                                          c["first_rows"], "cpu", steps=1,
                                          **kw)
        return first, reference.train_reference(c["m"], c["job"], SEED,
                                                c["rows"], "cpu", **kw)
    first, ref = both()
    ctl_first, ctl = both(quant="fp8")
    got = bench.train_numbers(ctl["phase_units"], ctl_first["grad_norms"],
                              ctl["losses"], ctl["moment"], ctl["change"],
                              first, ref)
    assert any(v > run.limits[k]["limit"] for k, v in got.items()
               if k in run.limits), got


@pytest.mark.parametrize("cell", SERVE)
def test_serving_control_departs(cell):
    """At this size float8 flips a few near ties where the program flips
    none; the limit, which the control exceeds ten times over at the
    cell's size (32 layers, a 200,064-token vocabulary), comes from the
    card."""
    from perfbench.loops.closed_loop import widest_gap
    run = smoke_run(cell, SEED, "bfloat16")
    c = run.values["serve_check"]
    ctl = reference.served_logits(c["m"], SEED, "cpu", c["seqs"],
                                  quant="fp8")
    gap = widest_gap(c["logits"], [lg.argmax(1).tolist() for lg in ctl])
    sound = run.checks[0][1]
    assert gap > 0 and gap > 3 * sound, (gap, sound)


def test_smoke_sizes_are_small():
    cfg, mix = smoke_files("phi4-chat-c64", "bfloat16")
    assert cfg["hidden_size"] <= 128 and mix["clients"] <= 4
    assert torch.get_default_dtype() == torch.float32


@pytest.mark.gpu
@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_control_fails_the_cell_on_the_card(cell):
    """The control at the cell's own size, on the card: it fails one of
    the cell's numbers (a short window; about a minute a cell)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from perfbench import calibrate
    run = bench.Run(cell, SEED, 3.0, False)
    run.go()
    got = (calibrate.train_readings(run) if cell in TRAIN
           else calibrate.serve_readings(run))
    assert run.result()["correct"]
    assert any(v > run.limits[k]["limit"]
               for k, v in got["control_fp8"].items() if k in run.limits)
