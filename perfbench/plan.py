"""DreamDDP's synchronisation plan worked out again from the paper: which
layer units each phase of a period averages.

A plain copy of the published method (§3.3 Algorithm 2 and §3.4 bubble
filling) over the planner's analytic profile, frozen here so that the
check compares the program's plan with the paper's and not with itself.
Units are in network order: 0 the embedding, 1..L the layers, L+1 the
head.  The profile: each unit's forward FLOPs at the planner's share of
the planning chip's peak, backward twice the forward, and a ring
all-reduce of its bfloat16 parameters, ``2 (K-1)/K bytes / bandwidth +
latency``.  The search reasons in backward order (position 0 is the
output-most unit): a DFS over interval partitions into ``H`` phases,
pruned by Property 1 (optimal hiding), Property 2 (delayed assignment)
and Property 3 (at least one), scored by Eq. 8 and re-ranked among
near-ties by the event timeline; then each phase gains the longest
prefix of output-most units whose extra sync leaves its timeline no
longer.

Plain Python; imports nothing of the program.
"""

from __future__ import annotations

EPS = 1e-12
NEAR_TIE = 1e-2                   # re-rank within 1% of Eq. 8's least
MAX_SOLUTIONS = 200_000


def unit_costs(m: dict, job: dict) -> list[tuple[float, float]]:
    """(n_params, forward FLOPs of one worker's batch) of every unit of a
    dense GQA decoder, in network order."""
    d, hd = m["d_model"], m["head_dim"]
    seq = job["seq"]
    tokens = job["batch_per_worker"] * seq
    proj = d * hd * (m["n_heads"] + 2 * m["n_kv_heads"]) + m["n_heads"] * hd * d
    block_p = proj + 3 * d * m["d_ff"] + 2 * d
    block_f = (2.0 * tokens * proj
               + 2.0 * tokens * seq * m["n_heads"] * hd * 2) \
        + 2.0 * tokens * d * m["d_ff"] * 3
    head_p = d + (0 if m["tie"] else d * m["vocab"])
    return ([(float(m["vocab"] * d), 2.0 * tokens * d)]
            + [(float(block_p), block_f)] * m["n_layers"]
            + [(float(head_p), 2.0 * tokens * d * m["vocab"])])


def profile(m: dict, job: dict, workers: int) -> tuple[list, list, float]:
    """(t_bp, t_comm) of every unit in backward order, and the whole
    forward's time."""
    hw = job["plan"]
    k = max(workers, 2)
    t_bp, t_comm, t_fp = [], [], 0.0
    for n_params, flops in unit_costs(m, job):      # network order
        fp = flops / (hw["peak_flops"] * hw["mfu"] * 1)
        t_fp += fp
        t_bp.append(fp * hw["bwd_fwd_ratio"])
        t_comm.append(2.0 * (k - 1) / k * (n_params * 2) / hw["bandwidth"]
                      + hw["latency"])
    return t_bp[::-1], t_comm[::-1], t_fp


def intervals(counts) -> list[tuple[int, int]]:
    out, s = [], 0
    for c in counts:
        out.append((s, s + c))
        s += c
    return out


def eq8(t_bp, t_comm, counts) -> float:
    """Paper Eq. 8: a period's backward and exposed communication time."""
    total_bp = sum(t_bp)
    out = 0.0
    for s, e in intervals(counts):
        if s == e:
            out += total_bp
            continue
        before = sum(t_bp[:s])
        rest = total_bp - before - t_bp[s]
        out += before + t_bp[s] + max(rest, sum(t_comm[s:e]))
    return out


def timeline(t_bp, t_comm, t_fp, positions) -> float:
    """One iteration that syncs ``positions``, each once its backward is
    done and the link is free: the forward, then the later of the
    backward's end and the last sync's."""
    done, acc = [], 0.0
    for t in t_bp:
        acc += t
        done.append(acc)
    free = 0.0
    for i in sorted(positions):
        free = max(done[i], free) + t_comm[i]
    return t_fp + max(acc, free)


def search(t_bp, t_comm, H: int) -> list[tuple[int, ...]]:
    """Algorithm 2's candidate partitions (phase counts, backward
    order)."""
    L = len(t_bp)
    suffix = [0.0] * (L + 1)
    for i in range(L - 1, -1, -1):
        suffix[i] = suffix[i + 1] + t_bp[i]
    out: list[tuple[int, ...]] = []

    def record(counts, cur):
        c = counts + [cur]
        out.append(tuple(c + [0] * (H - len(c))))

    def solve(pos, h, counts, cur, comm, start):
        if len(out) >= MAX_SOLUTIONS:
            return
        if pos == L:
            return record(counts, cur)
        if h == H - 1:
            return record(counts, cur + L - pos)
        if cur == 0:                                       # Property 3
            return solve(pos + 1, h, counts, 1, t_comm[pos], pos)
        budget = suffix[start] - t_bp[start]
        if budget >= comm + t_comm[pos]:                   # Property 1
            return solve(pos + 1, h, counts, cur + 1, comm + t_comm[pos],
                         start)
        if budget < comm:                                  # Property 2
            return solve(pos, h + 1, counts + [cur], 0, 0.0, pos)
        solve(pos + 1, h, list(counts), cur + 1, comm + t_comm[pos], start)
        solve(pos, h + 1, counts + [cur], 0, 0.0, pos)

    solve(0, 0, [], 0, 0.0, 0)
    return out


def phase_units(m: dict, job: dict, workers: int) -> list[tuple[int, ...]]:
    """The units each of the ``H`` phases averages, in network order."""
    H = job["period"]
    t_bp, t_comm, t_fp = profile(m, job, workers)
    L = len(t_bp)
    if H == 1:
        best = (L,)
    else:
        h_eff = min(H, L)
        scored = sorted(((eq8(t_bp, t_comm, c + (0,) * (H - h_eff)),
                          c + (0,) * (H - h_eff))
                         for c in search(t_bp, t_comm, h_eff)),
                        key=lambda t: t[0])
        cutoff = scored[0][0] * (1.0 + NEAR_TIE) + EPS
        near = [c for v, c in scored if v <= cutoff][:64]
        best = min(near, key=lambda c: sum(
            timeline(t_bp, t_comm, t_fp, range(s, e)) for s, e in intervals(c)))
    out = []
    for s, e in intervals(best):
        own = set(range(s, e))
        base = timeline(t_bp, t_comm, t_fp, own)
        extra: list[int] = []
        for pos in range(L):
            if pos in own:
                continue
            if timeline(t_bp, t_comm, t_fp, own | set(extra) | {pos}) \
                    <= base + EPS:
                extra.append(pos)
            else:
                break
        out.append(tuple(sorted(L - 1 - p for p in own | set(extra))))
    return out
