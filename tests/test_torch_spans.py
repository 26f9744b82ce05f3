"""The port's timing instrumentation (``repro_torch.spans``), torch only.

* **Spans** — ``span`` is one shared no-op context without a profiler
  and a named range with one; the training runner and the serving engine
  open their ``repro_torch.<loop>.<part>`` spans under
  ``torch.profiler``; ``record_function`` appears nowhere else in the
  port.
* **Phase marks** — ``PhaseMarks`` on a fake clock: parts in the order
  they were first marked, a part marked again moves its boundary, phases
  chained; a ``pipeline`` and a ``compiled`` fit on the CPU (parameter
  averaging, int8 syncs, gradient averaging) write ``grads_s``,
  ``optimizer_s`` and ``sync_s`` into every history row, each >= 0, a
  period's parts summing to no more than its host time.  On the card,
  the marks of a replayed period are read after its one synchronize.
* **Serving** — every completion's submit <= admit <= first token <=
  finish, with ``queue_s`` = admit - submit; ``EngineStats.steps``
  counts the steps that ran work and ``host_time_s`` lies between 0 and
  their summed wall time.  Host values reach the card through
  ``upload``, so on the card a step synchronizes only in its two
  readbacks, which ``host_time_s`` leaves out.
* **Readers** — ``launch.train`` prints the marked parts a step and
  ``launch.serve`` the host time a step and the queue wait's p95.
"""

from __future__ import annotations

import linecache
import time
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.api import JobConfig, Session  # noqa: E402
from repro_torch.device import upload, upload_into  # noqa: E402
from repro_torch.models.transformer import DecoderLM, LMConfig  # noqa: E402
from repro_torch.serve import EngineConfig, Request, ServeEngine  # noqa: E402
from repro_torch.spans import PhaseMarks, span  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
PART_KEYS = ("grads_s", "optimizer_s", "sync_s")
_TINY = dict(name="t", n_layers=4, d_model=48, n_heads=4, n_kv_heads=2,
             d_ff=96, vocab=64, param_dtype="float32", remat=False)

torch.set_num_threads(1)


def _host_ranges(prof) -> set[str]:
    return {e.name for e in prof.events()}


# ---------------------------------------------------------------- spans

def test_span_is_a_shared_noop_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a, b = span("repro_torch.test.a"), span("repro_torch.test.b")
    assert a is b
    with a:
        pass


def test_span_is_a_named_range_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("repro_torch.test.part"):
            torch.ones(3).add_(1)
    names = [e.name for e in prof.events()]
    assert "repro_torch.test.part" in names
    assert "aten::add_" in names


def test_record_function_is_used_by_span_alone():
    users = [p.relative_to(SRC).as_posix()
             for p in sorted((SRC / "repro_torch").rglob("*.py"))
             if "record_function" in p.read_text()]
    assert users == ["repro_torch/spans.py"]


# ---------------------------------------------------------- phase marks

class _Clock:
    def __init__(self, monkeypatch):
        self.t = 0.0
        monkeypatch.setattr(spans.time, "perf_counter", lambda: self.t)

    def at(self, t):
        self.t = t


def test_phase_marks_on_a_fake_clock(monkeypatch):
    clock = _Clock(monkeypatch)
    marks = PhaseMarks(2)
    clock.at(10.0)
    marks.start(torch.device("cpu"))
    p0 = marks.phase(0)
    for t, part in ((11.0, "grads"), (11.5, "optimizer"), (11.75, "sync"),
                    (12.0, "sync")):        # a make-up's extra sync
        clock.at(t)
        p0(part)
    p1 = marks.phase(1)                     # averages the gradients first
    for t, part in ((13.0, "grads"), (13.25, "sync"), (14.0, "optimizer")):
        clock.at(t)
        p1(part)
    assert marks.read() == [
        {"grads_s": 1.0, "optimizer_s": 0.5, "sync_s": 0.5},
        {"grads_s": 1.0, "optimizer_s": 0.75, "sync_s": 0.25}]
    assert marks.n_phases == 2


def _session(algo, exec_, H=3, **kw):
    return Session(JobConfig(algo=algo, workers=2, period=H, seq=16,
                             batch_per_worker=2, lr=3e-3, warmup_steps=2,
                             decay_steps=50, period_exec=exec_, **kw),
                   model=DecoderLM(LMConfig(**_TINY)), device="cpu")


@pytest.mark.parametrize("algo,exec_", [
    pytest.param("dreamddp", "pipeline", id="dreamddp-pipeline"),
    pytest.param("dreamddp", "compiled", id="dreamddp-compiled"),
    pytest.param("dreamddp-int8", "compiled", id="dreamddp-int8-compiled"),
    pytest.param("ssgd", "pipeline", id="ssgd-pipeline"),
])
def test_fit_writes_each_phase_parts(algo, exec_):
    sess = _session(algo, exec_, H=3)
    H = sess.plan.H                         # ssgd syncs every step: 1
    sess.fit(2 * H)
    rows, periods = sess.history, sess.runner.period_times
    assert len(rows) == 2 * H and len(periods) == 2
    for row in rows:
        assert all(row[k] >= 0.0 for k in PART_KEYS), row
        assert row["grads_s"] > 0.0 and row["optimizer_s"] > 0.0
    for p, host in enumerate(periods):
        marked = sum(r[k] for r in rows[p * H:(p + 1) * H]
                     for k in PART_KEYS)
        assert 0.0 < marked <= host
    # every phase of these plans syncs something
    assert all(r["sync_s"] > 0.0 for r in rows)


def test_a_makeup_period_times_its_extra_sync():
    H = 3
    sess = _session("dreamddp", "compiled", H=H).fit(H)
    r = sess.runner
    r.pending_units.update(r.plan.all_sync_units())
    sess.fit(H)
    rows = sess.history[H:]
    assert r._phase_marks(tuple(sorted(r.plan.all_sync_units()))) \
        is not r._phase_marks(())
    assert all(row[k] > 0.0 for row in rows for k in PART_KEYS)


def test_the_per_step_path_writes_no_parts():
    sess = _session("dreamddp", "pipeline", fused_period=False).fit(2)
    assert all(not set(PART_KEYS) & set(row) for row in sess.history)


def test_the_runner_opens_its_spans():
    sess = _session("dreamddp", "pipeline", H=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sess.fit(6)
    names = _host_ranges(prof)
    for part in ("period", "prefetch", "drain"):
        assert f"repro_torch.train.{part}" in names, part
    assert {"repro_torch.sync", "repro_torch.optimizer"} <= names


@pytest.mark.gpu
def test_replayed_periods_are_marked_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs run on the card)")
    H = 3
    sess = Session(JobConfig(algo="dreamddp-int8", workers=2, period=H,
                             seq=32, batch_per_worker=2,
                             period_exec="compiled"), device="cuda")
    sess.fit(4 * H)                    # eager, then three replays
    assert sess.runner.graph_stats.replays[()] == 3
    for p, host in enumerate(sess.runner.period_times):
        rows = sess.history[p * H:(p + 1) * H]
        assert all(r[k] > 0.0 for r in rows for k in PART_KEYS), rows
        marked = sum(r[k] for r in rows for k in PART_KEYS)
        assert 0.0 < marked <= host


# -------------------------------------------------------------- serving

def _engine(**kw):
    model = DecoderLM(LMConfig(**_TINY))
    params = model.init(torch.Generator().manual_seed(0))
    cfg = dict(max_batch=2, max_seq=32, decode_block=4)
    cfg.update(kw)
    return ServeEngine(model, params, EngineConfig(**cfg), device="cpu")


def _requests(n=5):
    return [Request(tokens=[(7 * i + j) % 60 + 1 for j in range(4 + i)],
                    max_new_tokens=3 + i % 3) for i in range(n)]


@pytest.mark.parametrize("backend,batched", [
    pytest.param("contiguous", True, id="contiguous-batched"),
    pytest.param("paged", True, id="paged-batched"),
    pytest.param("contiguous", False, id="contiguous-serial"),
])
def test_each_request_is_admitted_between_submit_and_first_token(
        backend, batched):
    kw = dict(kv_backend=backend, batched_admission=batched)
    if backend == "paged":
        kw["page_size"] = 8
    engine = _engine(**kw)
    seen = {}
    finish = engine.scheduler.finish

    def keep(slot):
        rs = finish(slot)
        seen[rs.request.request_id] = rs
        return rs

    engine.scheduler.finish = keep
    reqs = _requests()                      # 5 requests on 2 slots
    comps = engine.generate(reqs)
    assert len(comps) == len(reqs)
    for c in comps:
        rs = seen[c.request_id]
        end = rs.submit_t + c.latency_s
        assert rs.submit_t <= rs.admit_t <= rs.first_token_t <= end
        assert c.queue_s == rs.admit_t - rs.submit_t
        assert c.queue_s <= c.ttft_s <= c.latency_s
    # three requests waited for a slot to free
    assert sum(c.queue_s > max(d.ttft_s for d in comps[:2])
               for c in comps[2:]) == 3


def test_host_time_lies_within_the_steps_wall_time():
    engine = _engine()
    for r in _requests():
        engine.submit(r)
    wall, worked = 0.0, 0
    while engine.has_work:
        t0 = time.perf_counter()
        engine.step()
        wall += time.perf_counter() - t0
        worked += 1
    engine.step()                          # no work: not counted
    st = engine.stats
    assert st.steps == worked > 0
    assert 0.0 < st.host_time_s <= wall
    assert st.as_dict()["steps"] == worked
    assert engine.reset().stats.steps == 0


def test_the_engine_opens_its_spans():
    engine = _engine(max_batch=4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.generate(_requests(3))
    names = _host_ranges(prof)
    for part in ("step", "schedule", "prefill", "prefill_layer",
                 "prefill_commit",
                 "first_token_read", "block_inputs", "block", "block_read",
                 "harvest"):
        assert f"repro_torch.serve.{part}" in names, part


def test_upload_copies_host_values():
    arr = np.arange(6, dtype=np.int32).reshape(2, 3)
    t = upload(arr, torch.device("cpu"))
    arr[0, 0] = 99                          # a copy, not a view
    assert t.dtype == torch.int32 and t.tolist() == [[0, 1, 2], [3, 4, 5]]
    assert upload([0.5, 1], "cpu", torch.float32).tolist() == [0.5, 1.0]
    assert upload([3, 4], "cpu", torch.long).dtype == torch.long
    x = torch.ones(2, dtype=torch.int32)
    assert upload(x, "cpu", torch.float32).dtype == torch.float32
    dst = torch.zeros(2, 3, dtype=torch.int32)
    upload_into(dst, arr)
    assert dst[0, 0] == 99 and dst[1, 2] == 5


@pytest.mark.gpu
def test_a_serve_step_waits_only_in_its_readbacks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the waits are the card's)")
    from repro_torch.configs import granite_3_2b   # the kernels' widths
    from repro_torch.serve import SamplingParams
    model = DecoderLM(granite_3_2b.SMOKE)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    reqs = _requests()
    for i, r in enumerate(reqs[1::2]):      # some lanes sample
        r.sampling = SamplingParams(temperature=1.5, top_k=20, seed=i)
    for backend, batched in (("paged", True), ("contiguous", True),
                             ("contiguous", False)):
        engine = ServeEngine(model, params, EngineConfig(
            max_batch=2, max_seq=32, decode_block=4, kv_backend=backend,
            page_size=8, batched_admission=batched), device="cuda")
        engine.generate(reqs)               # builds, captures, warms up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                engine.generate(reqs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        waits = {linecache.getline(w.filename, w.lineno).strip()
                 for w in got if "synchroniz" in str(w.message)}
        assert waits and all(".cpu()" in line or ".tolist()" in line
                             for line in waits), (backend, batched, waits)


def test_the_launchers_print_what_the_spans_count(capsys):
    from repro_torch.launch.serve import main as serve
    from repro_torch.launch.train import main as train
    assert train(["--smoke", "--device", "cpu", "--steps", "4", "--workers",
                  "2", "--batch-per-worker", "2", "--seq", "16", "--period",
                  "2", "--algo", "dreamddp"]) == 0
    out = capsys.readouterr().out
    assert "ms/step by part: grads=" in out and "sync=" in out
    assert serve(["--arch", "granite-3-2b", "--smoke", "--device", "cpu",
                  "--batch", "3", "--max-batch", "2", "--prompt-len", "5",
                  "--gen", "2"]) == 0
    out = capsys.readouterr().out
    assert "ms/step (" in out and "queue wait p95=" in out
