"""The open serving loop: requests arrive by a Poisson process at a rate
fixed in the mix, whether or not earlier ones have been answered, over
``ServeEngine.submit`` and ``ServeEngine.step``.

The mix gives ``rate`` (requests a second); arrival gaps are
exponential, independent draws from the seed (:class:`Arrivals`), and
request ``i`` takes the sizes of client ``i mod C``'s next request of
:class:`perfbench.traffic.ClosedLoop` (``C`` the mix's ``clients``), so
any stretch of arrivals covers the length quantiles evenly.  Every
request is timed from its scheduled arrival, not from when the loop got
round to submitting it: a loop busy in a step submits the arrivals it
missed with their own times.  Set-up builds the engine (its decode
graphs captured) on the benchmark's weights, serves one short request
alone (which builds the prefill's kernels before the clock of the
arrivals starts) and runs the arrivals until ``warmup_completions``
requests have finished; the window then counts the tokens harvested in
it and times every request that arrived in it; the requests that arrived
in the window have ``drain_s`` seconds after it to finish, or count as
failed.  Each request's wait for a slot (``Completion.queue_s``) is
kept.  A traced run first profiles ``trace_steps`` more steps.  Then the
engine is freed and the reference reads a sample of the finished
requests, as the closed loop's check does.

:func:`serve_open` is the loop itself; ``perfbench.knee`` sweeps it over
rates to find the highest the engine sustains.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import reference
from ..traffic import ClosedLoop
from ..weights import dense_params
from .closed_loop import Record, Tally, check_sample, widest_gap


class Arrivals:
    """Scheduled arrivals: ``next_gap()`` seconds to the next, and the
    next request's (prompt, output length).  The gaps are independent
    exponential draws at ``rate`` from the seed: a Poisson process, as
    many independent users make, whose bursts and lulls are the seed's."""

    def __init__(self, mix: dict, vocab: int, seed: int, rate: float):
        self.sizes = ClosedLoop(mix, vocab, seed)
        self.rng = np.random.default_rng([seed, 2])
        self.rate, self.count = rate, 0

    def next_gap(self) -> float:
        return float(self.rng.exponential(1.0 / self.rate))

    def next(self) -> tuple[list[int], int]:
        client = self.count % len(self.sizes.count)
        self.count += 1
        return self.sizes.next(client)


class OpenLoop:
    """One engine under open-loop arrivals; :meth:`step` advances it."""

    def __init__(self, engine, arrivals: Arrivals, vocab: int):
        from repro_torch.serve import Request
        self.Request = Request
        self.engine, self.arrivals, self.vocab = engine, arrivals, vocab
        self.owner: dict[int, Record] = {}
        self.queue_s: dict[int, float] = {}
        self.tally = Tally()
        self.window = (float("inf"), float("inf"))   # [opens, closes)
        self.arriving = True
        self.due = time.perf_counter()
        self.finished = 0

    def on_token(self, rid, token, index):
        now = time.perf_counter()
        rec = self.owner[rid]
        rec.tokens.append(token)
        rec.last_t = now
        self.tally.tokens += 1
        n = len(rec.prompt)
        if index == 0:
            rec.first_t = now
            self.tally.prompts.append(n)
        else:
            self.tally.kv_lens.append(n + index)

    def submit_due(self) -> None:
        """Submit every arrival scheduled up to now, each with its own
        scheduled time."""
        now = time.perf_counter()
        while self.arriving and self.due <= now:
            prompt, out = self.arrivals.next()
            rid = self.engine.submit(
                self.Request(tokens=prompt, max_new_tokens=out),
                on_token=self.on_token, submit_t=self.due)
            opens, closes = self.window
            self.owner[rid] = Record(None, prompt, out, self.due,
                                     opens <= self.due < closes)
            self.due += self.arrivals.next_gap()

    def step(self) -> int:
        """Submit what is due, then one engine step (or, with nothing to
        do, wait for the next arrival).  Returns completions."""
        self.submit_due()
        if not self.engine.has_work:
            if self.arriving:
                time.sleep(max(0.0, min(self.due - time.perf_counter(),
                                        1e-3)))
            return 0
        comps = self.engine.step()
        for comp in comps:
            rec = self.owner[comp.request_id]
            rec.finished = True
            rec.done = comp.finish_reason == "length" \
                and comp.tokens == rec.tokens
            self.queue_s[comp.request_id] = comp.queue_s
        self.finished += len(comps)
        return len(comps)

    def backlog(self) -> int:
        """Requests submitted and not finished (queued or in a slot)."""
        return sum(not r.finished for r in self.owner.values())


def serve_open(engine, mix: dict, vocab: int, seed: int, rate: float,
               seconds: float, *, run=None) -> dict:
    """Warm up, then one window of ``seconds`` at ``rate``.  With
    ``run``, its window and marks are used.  Returns the loop, the
    window's tally and engine counters, the requests that arrived in the
    window (``offered``, their count), the requests that finished in it
    (``completed``, whenever they arrived) and those submitted and not
    finished at its end (``backlog``: in a slot or queued)."""
    # one short request alone first: the kernels a first prompt builds
    # are built before the arrivals' clock starts
    from repro_torch.serve import Request
    engine.submit(Request(tokens=list(range(1, 17)), max_new_tokens=2))
    while engine.has_work:
        engine.step()
    loop = OpenLoop(engine, Arrivals(mix, vocab, seed, rate), vocab)
    while loop.finished < mix["warmup_completions"]:
        loop.step()
    if run is not None:
        run.mark(f"warm-up done ({len(loop.owner)} requests sent)")
    stats, blocks = engine.stats, engine.block_stats

    def snapshot():
        return (stats.prefill_time_s, stats.decode_time_s,
                stats.slot_ticks_active, stats.slot_ticks_total,
                blocks.ticks_run)

    loop.tally = window = Tally()
    s0 = snapshot()
    if run is not None:
        run.start_window()
    opened = time.perf_counter()
    finished0 = loop.finished
    # the window's requests: those scheduled to arrive in it
    loop.window = (opened, opened + seconds)
    while time.perf_counter() - opened < seconds:
        loop.step()
    # every arrival scheduled in the window is the window's, even one due
    # while its last step ran
    loop.submit_due()
    if run is not None:
        run.end_window()
    closed = time.perf_counter()
    s1 = snapshot()
    loop.tally = Tally()
    recs = [r for r in loop.owner.values() if r.in_window]
    return {"loop": loop, "window": window, "recs": recs,
            "engine": [b - a for a, b in zip(s0, s1, strict=True)],
            "offered": len(recs), "completed": loop.finished - finished0,
            "backlog": loop.backlog(), "window_s": closed - opened}


def drive(run) -> None:
    from repro_torch.serve import EngineConfig, ServeEngine

    model, m = run.model()
    mix = run.traffic
    e = mix["engine"]
    params = dense_params(m, run.seed, run.device, getattr(torch, m["dtype"]))
    run.mark("weights drawn")
    engine = ServeEngine(model, params, EngineConfig(
        max_batch=e["slots"], max_seq=e["max_seq"],
        decode_block=e["decode_block"], kv_backend="paged",
        page_size=e["page_size"]), device=run.device)
    run.mark(f"engine built (graphs {engine.block_stats.capture_s:.3f} s)")
    got = serve_open(engine, mix, m["vocab"], run.seed, mix["rate"],
                     run.seconds, run=run)
    loop, window, d = got["loop"], got["window"], got["engine"]
    run.values.update(
        tokens=window.tokens, model=m, prompts=window.prompts,
        kv_lens=window.kv_lens, prefill_time_s=d[0], decode_time_s=d[1],
        slot_ticks_active=d[2], slot_ticks_total=d[3], ticks_run=d[4])
    run.info.update(offered=got["offered"], completed_in_window=got[
        "completed"], backlog_at_end=got["backlog"])

    if run.trace:
        loop.tally = sliced = Tally()
        run.profile(lambda: [loop.step()
                             for _ in range(mix["trace_steps"])])
        loop.tally = Tally()
        run.values["slice"] = {"prompts": sliced.prompts,
                               "kv_lens": sliced.kv_lens,
                               "page_size": e["page_size"]}

    loop.arriving = False
    closed = time.perf_counter()
    recs = got["recs"]
    while not all(r.finished for r in recs) \
            and time.perf_counter() - closed < mix["drain_s"]:
        loop.step()
    end = time.perf_counter()
    for r in recs:
        if len(r.tokens) != r.out_len or not r.done \
                or not all(0 <= t < m["vocab"] for t in r.tokens):
            r.done = False
    # a failed request counts with the time it waited
    run.values["requests"] = [
        (r.first_t - r.submit_t, (r.last_t - r.first_t) / (len(r.tokens) - 1))
        if r.done else (end - r.submit_t, end - r.submit_t)
        for r in recs]
    rid_of = {id(r): rid for rid, r in loop.owner.items()}
    run.values["queue_s"] = [loop.queue_s.get(rid_of[id(r)], end - r.submit_t)
                             for r in recs]
    run.attempted = len(recs)
    run.failed = sum(not r.done for r in recs)

    run.read_memory()
    del engine, params, loop
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()
    sample = check_sample([r for r in recs if r.done], mix["check"],
                          run.seed)
    seqs = [(r.prompt + r.tokens[:-1],
             list(range(len(r.prompt) - 1, len(r.prompt) + len(r.tokens) - 1)))
            for r in sample]
    run.mark("drained, engine freed")
    logits = reference.served_logits(m, run.seed, run.device, seqs)
    run.values["serve_check"] = {"m": m, "seqs": seqs, "logits": logits,
                                 "tokens": [r.tokens for r in sample]}
    run.values["checked_tokens"] = sum(len(r.tokens) for r in sample)
    run.check("served_logit_gap", widest_gap(
        logits, [r.tokens for r in sample]))
    run.mark(f"reference read {run.values['checked_tokens']} tokens")
