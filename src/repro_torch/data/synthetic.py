"""Deterministic synthetic data (offline: no external data).

Counterpart of ``repro.data.synthetic``:

* :class:`MarkovCorpus` — an order-1 Markov chain over the vocabulary
  with a low-entropy transition structure; a model that learns the
  transitions drives the loss well below the unigram entropy, so
  convergence curves are informative;
* :class:`TeacherImages` — a frozen random "teacher" MLP labels random
  images (the reference's stand-in for CIFAR).

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

__all__ = ["MarkovCorpus", "TeacherImages"]


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


@dataclass
class TeacherImages:
    """Random images labelled by a frozen random teacher MLP,
    ``argmax(tanh(x @ w1) @ w2)``.

    The teacher's two matrices are the reference's: the same draws from
    ``numpy.random.default_rng(seed + 7)``, so they are equal exactly.
    Worker ``k``'s images at ``step`` come from a ``torch.Generator`` on
    ``device`` seeded from the stream ``(seed * 1000 + k, step)`` (folded
    by numpy's ``SeedSequence``): IID across workers, a pure function of
    the step, and the port's own stream, as :class:`MarkovCorpus`'s is
    (JAX's PRNG has no counterpart; parity tests label the reference's
    images with :meth:`labels`)."""

    n_classes: int
    image_dim: int               # flattened image size
    batch_per_worker: int
    n_workers: int
    seed: int = 0
    device: str | torch.device = "cpu"

    def __post_init__(self):
        rng = np.random.default_rng(self.seed + 7)
        w1 = rng.normal(0, 1 / np.sqrt(self.image_dim),
                        (self.image_dim, 128))
        w2 = rng.normal(0, 1 / np.sqrt(128), (128, self.n_classes))
        self._w1, self._w2 = (
            torch.from_numpy(w.astype(np.float32)).to(self.device)
            for w in (w1, w2))

    def labels(self, images: torch.Tensor) -> torch.Tensor:
        """The teacher's int32 class of each image ``[..., image_dim]``."""
        logits = torch.tanh(images @ self._w1) @ self._w2
        return logits.argmax(-1).to(torch.int32)

    def batch(self, step: int) -> dict:
        """Worker-stacked ``{images [W, B, image_dim] float32, labels
        [W, B] int32}`` on ``device``."""
        gen = torch.Generator(self.device)
        xs = []
        for k in range(self.n_workers):
            ss = np.random.SeedSequence([self.seed * 1000 + k, int(step)])
            gen.manual_seed(int(ss.generate_state(1, np.uint64)[0] >> 1))
            xs.append(torch.randn(self.batch_per_worker, self.image_dim,
                                  generator=gen, device=self.device))
        images = torch.stack(xs)
        return {"images": images, "labels": self.labels(images)}
