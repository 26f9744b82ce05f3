"""The generators repeat exactly by seed, give every seed the same sizes,
and draw rows that all differ."""

import json
from pathlib import Path

import pytest
import torch

from perfbench.loops.train import SeededRows
from perfbench.traffic import ClosedLoop, quantile

MIXES = Path(__file__).resolve().parents[1] / "traffic"
SERVE = sorted(p.stem for p in MIXES.glob("*.json")
               if json.loads(p.read_text())["loop"] == "closed_loop")
BIG = 2**31 + 977


def mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


def draw(loop: ClosedLoop, n: int):
    return [loop.next(c) for _ in range(n) for c in range(len(loop.count))]


@pytest.mark.parametrize("name", SERVE)
def test_closed_loop_repeats_by_seed(name):
    a = draw(ClosedLoop(mix(name), 1000, BIG), 3)
    b = draw(ClosedLoop(mix(name), 1000, BIG), 3)
    c = draw(ClosedLoop(mix(name), 1000, BIG + 1), 3)
    assert a == b
    assert a != c


def mean_sizes(loop: ClosedLoop, per_client: int):
    sizes = [loop.sizes(c, i) for c in range(len(loop.count))
             for i in range(per_client)]
    return [sum(s[k] for s in sizes) / len(sizes) for k in (0, 1)]


@pytest.mark.parametrize("name", SERVE)
def test_every_seed_sends_nearly_the_same_sizes(name):
    """The ~280 requests a window takes at the least, a few from each
    client, have nearly the same mean lengths whatever the seed, and the
    distribution's own means."""
    m = mix(name)
    per_client = 280 // m["clients"]
    us = [(k + 0.5) / 20000 for k in range(20000)]
    want = [sum(quantile(m[key], u) for u in us) / len(us)
            for key in ("prompt", "output")]
    for seed in (1, 77, BIG):
        got = mean_sizes(ClosedLoop(m, 1000, seed), per_client)
        for g, w in zip(got, want, strict=True):
            assert abs(g - w) <= 0.03 * w
    loop = ClosedLoop(m, 1000, BIG)
    for c in range(len(loop.count)):
        for i in range(50):
            p, o = loop.sizes(c, i)
            assert m["prompt"]["min"] <= p <= m["prompt"]["max"]
            assert m["output"]["min"] <= o <= m["output"]["max"]
            assert p + o <= m["engine"]["max_seq"]


@pytest.mark.parametrize("name", SERVE)
def test_medians(name):
    m = mix(name)
    if m["prompt"]["dist"] == "lognormal":
        assert quantile(m["prompt"], 0.5) == m["prompt"]["median"]


def test_rows_repeat_and_differ():
    a = SeededRows(49155, 4, 4, 512, BIG)
    b = SeededRows(49155, 4, 4, 512, BIG)
    assert torch.equal(a.tokens(3), b.tokens(3))
    rows = torch.cat([a.tokens(s).reshape(-1, 512) for s in range(4)])
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
    assert int(rows.max()) < 49155 and int(rows.min()) >= 0
