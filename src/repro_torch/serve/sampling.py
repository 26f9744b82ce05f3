"""Per-slot token sampling: greedy / temperature / top-k, seeded per lane.

Counterpart of ``repro.serve.sampling``.  All three modes run branch-free
over the slot axis so a batch can mix greedy and sampled requests lane by
lane: temperature 0 selects the argmax (the first maximal index on ties,
as ``jnp.argmax``), ``top_k == 0`` disables truncation, and the top-k
threshold keeps ties (``logits >= thresh``).

Randomness comes in as one uniform number per lane, drawn by the caller
from that request's own ``torch.Generator`` (seeded from
``SamplingParams.seed``), and picks a token by inverse CDF.  A request's
stream therefore depends only on its own seed and logits, never on what
shares the batch.  JAX's PRNG streams cannot be reproduced, so seeded
sampling matches the reference in distribution, not token for token.
"""

from __future__ import annotations

import torch

__all__ = ["make_token_sampler", "draw_uniform"]


def draw_uniform(gen: torch.Generator) -> float:
    """One U[0, 1) draw from a request's host-side generator."""
    return float(torch.rand((), generator=gen))


def make_token_sampler(vocab: int):
    """Build ``sample(logits [S, V], temp [S], top_k [S], u [S]) ->
    tokens [S]`` (int32)."""

    def sample(logits: torch.Tensor, temp: torch.Tensor,
               top_k: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        greedy = logits.argmax(-1)
        logits = logits.float()
        k = torch.where(top_k > 0, top_k, vocab).clamp(1, vocab) - 1
        desc = logits.sort(-1, descending=True).values
        thresh = desc.gather(-1, k[:, None].long())
        masked = torch.where(logits >= thresh, logits, -torch.inf)
        probs = torch.softmax(masked / temp.clamp_min(1e-6)[:, None], -1)
        cdf = probs.cumsum(-1)
        target = (u.float() * cdf[:, -1])[:, None]
        sampled = torch.searchsorted(cdf, target, right=True)[:, 0]
        sampled = sampled.clamp_max(vocab - 1)
        return torch.where(temp > 0, sampled, greedy).to(torch.int32)

    return sample
