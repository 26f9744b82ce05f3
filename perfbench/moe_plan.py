"""DreamDDP's plan worked out again for an MLA + MoE decoder: the paper's
Algorithm 2 and bubble filling (:mod:`perfbench.plan`'s ``search``,
``eq8``, ``timeline``, ``intervals``) over this model's units, whose
costs are uneven: the embedding and the head are a slice of the
vocabulary, the leading layer is dense, and each MoE layer holds a share
of its experts (:func:`perfbench.moe_costs.unit_costs`).

Plain Python; imports nothing of the program.
"""

from __future__ import annotations

from .moe_costs import unit_costs
from .plan import EPS, NEAR_TIE, eq8, intervals, search, timeline

__all__ = ["profile", "phase_units"]


def profile(m: dict, job: dict, workers: int) -> tuple[list, list, float]:
    """(t_bp, t_comm) of every unit in backward order, and the whole
    forward's time, as :func:`perfbench.plan.profile` reckons them."""
    hw = job["plan"]
    k = max(workers, 2)
    t_bp, t_comm, t_fp = [], [], 0.0
    for n_params, flops in unit_costs(m, job["batch_per_worker"],
                                      job["seq"]):
        fp = flops / (hw["peak_flops"] * hw["mfu"] * 1)
        t_fp += fp
        t_bp.append(fp * hw["bwd_fwd_ratio"])
        t_comm.append(2.0 * (k - 1) / k * (n_params * 2) / hw["bandwidth"]
                      + hw["latency"])
    return t_bp[::-1], t_comm[::-1], t_fp


def phase_units(m: dict, job: dict, workers: int) -> list[tuple[int, ...]]:
    """The units each of the ``H`` phases averages, in network order (0
    the embedding, 1..L the layers, L+1 the head)."""
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
