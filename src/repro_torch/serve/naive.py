"""The pre-engine serving loop, kept as reference semantics.

Counterpart of ``repro.serve.naive``: one fixed batch at a time, a fresh
full-size KV cache per call, and a greedy Python decode loop that runs
every sequence to ``max_new_tokens`` with no EOS exit.  It is the
engine's oracle in the equivalence tests.
"""

from __future__ import annotations

import torch

from ..device import resolve_device

__all__ = ["NaiveLoop"]


class NaiveLoop:
    """Per-batch greedy decoding with the model's prefill/decode steps."""

    def __init__(self, model, params, *, device=None):
        self.model = model
        self.params = params
        self.device = resolve_device(device)

    @torch.no_grad()
    def generate(self, tokens, max_new_tokens: int = 16) -> torch.Tensor:
        """Prefill ``tokens`` ``[B, S]`` then decode greedily to the full
        budget; returns ``[B, max_new_tokens]`` int32 on the device."""
        tokens = torch.as_tensor(tokens, dtype=torch.int32,
                                 device=self.device)
        b, s = tokens.shape
        if max_new_tokens <= 0:
            return torch.zeros((b, 0), dtype=torch.int32, device=self.device)
        cache = self.model.init_cache(b, s + max_new_tokens,
                                      device=self.device)
        logits, cache = self.model.prefill(self.params, tokens, cache)
        out = [logits.argmax(-1).to(torch.int32)]
        for i in range(max_new_tokens - 1):
            pos = torch.full((b,), s + i, dtype=torch.int32,
                             device=self.device)
            logits, cache = self.model.decode_step(self.params, cache,
                                                   out[-1], pos)
            out.append(logits.argmax(-1).to(torch.int32))
        return torch.cat(out, dim=1)

