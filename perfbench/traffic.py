"""The one generator of serving traffic, driven by a mix's parameters.

Lengths follow the mix's distributions through low-discrepancy
sequences, so that every seed sends nearly the same sizes in any stretch
of a run, in another order: client ``c``'s ``i``-th request takes the
prompt length at quantile ``frac(a_c + i / phi)`` and the output length
at quantile ``frac(b_c + i (sqrt 2 - 1))``.  The offsets are spread
evenly over the ``C`` clients, ``a_c = frac(r + c / C)`` and ``b_c =
frac(r' + p(c) / C)``, with ``r``, ``r'`` and the permutation ``p``
drawn from the seed: the clients' ``i``-th requests together cover the
quantiles evenly, and any ``n`` consecutive requests of one client cover
them to within about ``log(n) / n``, where independent draws would leave
``1 / sqrt(n)``.  Prompts are uniform over the vocabulary from ``(seed,
c, i)``.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

PROMPT_STEP = (math.sqrt(5) - 1) / 2          # 1 / golden ratio
OUTPUT_STEP = math.sqrt(2) - 1
EDGE = 1e-4                                   # quantiles kept off 0 and 1


def quantile(dist: dict, u: float) -> int:
    """The length at quantile ``u`` of ``dist``: ``lognormal`` (``median``,
    ``sigma``) or ``uniform``, clipped to ``[min, max]``."""
    u = min(max(u, EDGE), 1 - EDGE)
    if dist["dist"] == "lognormal":
        x = dist["median"] * math.exp(dist["sigma"] * NormalDist().inv_cdf(u))
    elif dist["dist"] == "uniform":
        x = dist["min"] + u * (dist["max"] - dist["min"] + 1) - 0.5
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return int(min(max(round(x), dist["min"]), dist["max"]))


class ClosedLoop:
    """Each client's request sequence for one run."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix, self.vocab, self.seed = mix, vocab, seed
        n = mix["clients"]
        rng = np.random.default_rng([seed, 0])
        r, r2 = rng.random(2)
        perm = rng.permutation(n)
        self.offsets = [((r + c / n) % 1.0, (r2 + perm[c] / n) % 1.0)
                        for c in range(n)]
        self.count = [0] * mix["clients"]

    def sizes(self, client: int, i: int) -> tuple[int, int]:
        """(prompt, output) lengths of the client's ``i``-th request."""
        a, b = self.offsets[client]
        return (quantile(self.mix["prompt"], (a + i * PROMPT_STEP) % 1.0),
                quantile(self.mix["output"], (b + i * OUTPUT_STEP) % 1.0))

    def next(self, client: int) -> tuple[list[int], int]:
        """(prompt token ids, tokens to generate) of the client's next
        request."""
        i = self.count[client]
        self.count[client] += 1
        prompt, out = self.sizes(client, i)
        rng = np.random.default_rng([self.seed, client, i])
        return rng.integers(0, self.vocab, prompt).tolist(), out
