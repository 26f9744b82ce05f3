"""The pre-engine serving loop, kept as reference semantics.

Counterpart of ``repro.serve.naive``: one fixed batch at a time, a fresh
full-size KV cache per call, and a greedy Python decode loop that runs
every sequence to ``max_new_tokens`` with no EOS exit.  It is the
engine's oracle in the equivalence tests.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..runtime.step import model_prefill, prefix_len

__all__ = ["NaiveLoop", "naive_generate"]


class NaiveLoop:
    """Per-batch greedy decoding with the model's prefill/decode steps
    (``frontend``: ``"vision"`` or ``"audio"``, whose inputs
    :meth:`generate` takes as ``extra``)."""

    def __init__(self, model, params, *, device=None,
                 frontend: str | None = None):
        self.model = model
        self.params = params
        self.device = resolve_device(device)
        self.frontend = frontend

    @torch.no_grad()
    def generate(self, tokens, max_new_tokens: int = 16,
                 *extra) -> torch.Tensor:
        """Prefill ``tokens`` ``[B, S]`` (with the frontend's inputs
        ``extra``, each ``[B, ...]``) then decode greedily to the full
        budget; returns ``[B, max_new_tokens]`` int32 on the device."""
        dev = self.device
        tokens = torch.as_tensor(tokens, dtype=torch.int32, device=dev)
        extra = [torch.as_tensor(a).to(dev) for a in extra]
        b, s = tokens.shape
        if max_new_tokens <= 0:
            return torch.zeros((b, 0), dtype=torch.int32, device=dev)
        # vision prefixes occupy cache positions before the prompt
        prefix = prefix_len(self.frontend, extra)
        cache = self.model.init_cache(b, prefix + s + max_new_tokens,
                                      device=dev)
        logits, cache = model_prefill(self.model, self.params, tokens, cache,
                                      *extra, frontend=self.frontend)
        out = [logits.argmax(-1).to(torch.int32)]
        for i in range(max_new_tokens - 1):
            pos = torch.full((b,), prefix + s + i, dtype=torch.int32,
                             device=dev)
            logits, cache = self.model.decode_step(self.params, cache,
                                                   out[-1], pos)
            out.append(logits.argmax(-1).to(torch.int32))
        return torch.cat(out, dim=1)


def naive_generate(model, params, tokens, max_new_tokens: int = 16,
                   *extra, frontend: str | None = None,
                   device=None) -> torch.Tensor:
    """One-shot helper around :class:`NaiveLoop`."""
    return NaiveLoop(model, params, device=device,
                     frontend=frontend).generate(tokens, max_new_tokens,
                                                 *extra)
