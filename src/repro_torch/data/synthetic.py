"""Deterministic synthetic corpus (offline: no external data).

Counterpart of ``repro.data.synthetic.MarkovCorpus``: an order-1 Markov
chain over the vocabulary with a low-entropy transition structure; a
model that learns the transitions drives the loss well below the unigram
entropy, so convergence curves are informative.

The transition table is the reference's, drawn from
``numpy.random.default_rng(seed)``.  The chain itself is sampled on the
host with numpy — one ``Generator`` per (worker, step), seeded from
``(seed * 1000 + k, step)``, so workers stay IID and every batch is a
pure function of its step — then copied to the device in one transfer.
JAX's PRNG has no counterpart here, so the tokens differ from the
reference's (parity tests feed the reference's batches instead).  A
batch costs ``seq_len`` vectorised numpy steps, not hundreds of device
launches (``repro/data/synthetic.py:47-51`` records why the latter is
too slow).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["MarkovCorpus"]


@dataclass
class MarkovCorpus:
    vocab: int
    seq_len: int
    batch_per_worker: int
    n_workers: int
    seed: int = 0
    branching: int = 4           # out-degree of each state (entropy knob)
    device: str | torch.device = "cpu"

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._nexts = rng.integers(0, self.vocab,
                                   size=(self.vocab, self.branching))
        self._probs = rng.dirichlet(np.ones(self.branching) * 0.5,
                                    size=self.vocab).astype(np.float32)
        self._cdf = np.cumsum(self._probs.astype(np.float64), axis=1)

    def _tokens(self, step: int) -> np.ndarray:
        w, b, s = self.n_workers, self.batch_per_worker, self.seq_len
        starts = np.empty((w, b), np.int64)
        u = np.empty((w, b, s), np.float64)
        for k in range(w):
            rng = np.random.default_rng([self.seed * 1000 + k, step])
            starts[k] = rng.integers(0, self.vocab, size=b)
            u[k] = rng.random((b, s))
        toks = np.empty((w * b, s), np.int32)
        tok = starts.reshape(-1)
        u = u.reshape(w * b, s)
        for t in range(s):
            toks[:, t] = tok
            idx = (u[:, t, None] > self._cdf[tok]).sum(-1)
            tok = self._nexts[tok, np.minimum(idx, self.branching - 1)]
        return toks.reshape(w, b, s)

    def batch(self, step: int) -> dict:
        """Worker-stacked batch ``{tokens, labels}: [W, B, S]`` (int64,
        one tensor on ``device``; labels are the tokens)."""
        toks = torch.from_numpy(self._tokens(int(step)).astype(np.int64))
        toks = toks.to(self.device)
        return {"tokens": toks, "labels": toks}

    def entropy_floor(self) -> float:
        """Per-token conditional entropy of the chain (nats) — the loss a
        perfect model reaches."""
        p = self._probs
        return float(-(p * np.log(p + 1e-12)).sum(-1).mean())
