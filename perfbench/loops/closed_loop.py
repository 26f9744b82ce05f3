"""The serving loop: a closed loop of clients over ``ServeEngine.submit``
and ``ServeEngine.step``.

Each client sends its next request as soon as its last one has
finished, so the card sets the pace; a request is timed from the moment
its client sent it, and the loop hands the engine whatever was sent
between two steps before the next.  Set-up builds the engine
(its decode graphs captured) on the benchmark's weights, starts every
client and runs until ``warmup_completions`` requests have finished, so
the window opens on a loop in its steady state with every prefill and
decode shape of the mix already run.  The window counts the tokens
harvested in it and times every request sent in it from the moment its
client sent it; once it closes no client sends again, and the requests
sent in it have ``drain_s`` seconds to finish or count as failed.  A
traced run first profiles ``trace_steps`` more steps of the loop.  Then
the engine is freed and the reference reads a sample of the finished
requests.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import costs, reference
from ..traffic import ClosedLoop
from ..weights import dense_params


class Record:
    """What the client sees of one request."""

    __slots__ = ("client", "prompt", "out_len", "submit_t", "first_t",
                 "last_t", "tokens", "in_window", "finished", "done")

    def __init__(self, client, prompt, out_len, submit_t, in_window):
        self.client, self.prompt, self.out_len = client, prompt, out_len
        self.submit_t, self.in_window = submit_t, in_window
        self.first_t = self.last_t = None
        self.tokens: list[int] = []
        self.finished = self.done = False


class Tally:
    """Work harvested between two step boundaries: tokens, and the lengths
    the kernels were given (prompt lengths; keys each decoded token
    read)."""

    def __init__(self):
        self.tokens = 0
        self.prompts: list[int] = []
        self.kv_lens: list[int] = []


def drive(run) -> None:
    from repro_torch.serve import EngineConfig, Request, ServeEngine

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
    gen = ClosedLoop(mix, m["vocab"], run.seed)
    owner: dict[int, Record] = {}
    state = {"tally": Tally(), "in_window": False, "sending": True,
             "opened": 0.0}

    def on_token(rid, token, index):
        now = time.perf_counter()
        rec = owner[rid]
        rec.tokens.append(token)
        rec.last_t = now
        tally = state["tally"]
        tally.tokens += 1
        n = len(rec.prompt)
        if index == 0:
            rec.first_t = now
            tally.prompts.append(n)
        else:
            tally.kv_lens.append(n + index)

    due: list[tuple[float, int]] = []           # (send time, client)

    def send(client, due_t):
        prompt, out = gen.next(client)
        rid = engine.submit(Request(tokens=prompt, max_new_tokens=out),
                            on_token=on_token, submit_t=due_t)
        rec = Record(client, prompt, out, due_t,
                     state["in_window"] and due_t >= state["opened"])
        owner[rid] = rec

    def step() -> int:
        for t, c in due:
            send(c, t)
        due.clear()
        if not engine.has_work:
            return 0
        comps = engine.step()
        now = time.perf_counter()
        for comp in comps:
            rec = owner[comp.request_id]
            rec.finished = True
            rec.done = comp.finish_reason == "length" \
                and comp.tokens == rec.tokens
            if state["sending"]:
                due.append((now, rec.client))
        return len(comps)

    start = time.perf_counter()
    for c in range(mix["clients"]):
        send(c, start)
    finished = 0
    while finished < mix["warmup_completions"]:
        finished += step()
    run.mark(f"warm-up done ({len(owner)} requests sent)")
    engine_stats = engine.stats
    blocks = engine.block_stats

    def snapshot():
        return (engine_stats.prefill_time_s, engine_stats.decode_time_s,
                engine_stats.slot_ticks_active,
                engine_stats.slot_ticks_total, blocks.ticks_run)

    state["tally"] = window = Tally()
    state["in_window"] = True
    s0 = snapshot()
    run.start_window()
    state["opened"] = time.perf_counter()
    while run.elapsed() < run.seconds:
        step()
    run.end_window()
    state["in_window"] = False
    s1 = snapshot()
    state["tally"] = Tally()
    d = [b - a for a, b in zip(s0, s1, strict=True)]
    run.values.update(
        tokens=window.tokens, model=m, prompts=window.prompts,
        kv_lens=window.kv_lens, prefill_time_s=d[0], decode_time_s=d[1],
        slot_ticks_active=d[2], slot_ticks_total=d[3], ticks_run=d[4])
    # K and V the pool held for the live lanes, on average over the
    # window's ticks (each decoded token is one live lane in one tick)
    kv_bytes = 2 * m["n_layers"] * m["n_kv_heads"] * m["head_dim"] \
        * costs.DTYPE_BYTES[m["dtype"]]
    if d[4]:
        run.info["live_kv_bytes_mean"] = \
            kv_bytes * sum(window.kv_lens) / d[4]

    if run.trace:
        state["tally"] = sliced = Tally()
        run.profile(lambda: [step() for _ in range(mix["trace_steps"])])
        state["tally"] = Tally()
        # the lengths every layer's launches in the slice were given
        run.values["slice"] = {"prompts": sliced.prompts,
                               "kv_lens": sliced.kv_lens,
                               "page_size": e["page_size"]}

    state["sending"] = False
    due.clear()
    closed = time.perf_counter()
    window_recs = [r for r in owner.values() if r.in_window]
    while not all(r.finished for r in window_recs) \
            and time.perf_counter() - closed < mix["drain_s"]:
        step()
    end = time.perf_counter()
    for r in window_recs:
        if len(r.tokens) != r.out_len or not r.done \
                or not all(0 <= t < m["vocab"] for t in r.tokens):
            r.done = False
    # a failed request counts with the time it waited
    run.values["requests"] = [
        (r.first_t - r.submit_t, (r.last_t - r.first_t) / (len(r.tokens) - 1))
        if r.done else (end - r.submit_t, end - r.submit_t)
        for r in window_recs]
    run.attempted = len(window_recs)
    run.failed = sum(not r.done for r in window_recs)

    run.read_memory()
    del engine, params
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()
    sample = check_sample([r for r in window_recs if r.done], mix["check"],
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


def widest_gap(logits, tokens) -> float:
    """The widest gap by which a served token's reference logit lies
    below the reference's best at its position."""
    gap = 0.0
    for lg, toks in zip(logits, tokens, strict=True):
        served = lg.gather(1, torch.tensor(toks, device=lg.device)[:, None])
        gap = max(gap, float((lg.amax(1, keepdim=True) - served).max()))
    return gap


def check_sample(done: list, check: dict, seed: int) -> list:
    """The requests the reference reads: the one with the most served
    tokens, then others in the seed's order until ``served_tokens`` are
    covered or ``max_requests`` taken."""
    if not done:
        return []
    longest = max(done, key=lambda r: len(r.tokens))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([seed, 1]).permutation(len(rest))
    out, n = [longest], len(longest.tokens)
    for i in order:
        if n >= check["served_tokens"] or len(out) >= check["max_requests"]:
            break
        out.append(rest[i])
        n += len(rest[i].tokens)
    return out
