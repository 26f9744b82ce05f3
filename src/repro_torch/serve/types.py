"""Serving request/response dataclasses — the engine's public data model.

A framework-free copy of ``repro.serve.types``.

A :class:`Request` is pure data: prompt tokens, a generation budget, a
:class:`SamplingParams`, an optional EOS token, and optional frontend
``extra`` inputs (audio frames / vision patch embeddings, unbatched).  The
engine answers with a :class:`Completion` and aggregates run-level numbers
into :class:`EngineStats`.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

__all__ = ["SamplingParams", "Request", "Completion", "EngineStats"]

_ids = itertools.count()


@dataclass(frozen=True)
class SamplingParams:
    """How the next token is chosen from the logits.

    ``temperature == 0`` is greedy argmax (the default, and the mode the
    engine/naive equivalence guarantees cover).  With ``temperature > 0``
    the distribution is optionally truncated to the ``top_k`` highest
    logits (``0`` = no truncation) and sampled with a PRNG stream derived
    from ``seed`` — the same request with the same seed always yields the
    same tokens, regardless of what else shares the batch.
    """

    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0


@dataclass
class Request:
    """One generation request (pure data; the engine never mutates it)."""

    tokens: Sequence[int]                  # prompt token ids
    max_new_tokens: int = 16
    sampling: SamplingParams = field(default_factory=SamplingParams)
    eos_id: int | None = None              # stop token (None: run to budget)
    extra: tuple = ()                      # frontend inputs, each [n, d]
    request_id: int = field(default_factory=lambda: next(_ids))


@dataclass
class Completion:
    """The engine's answer for one request."""

    request_id: int
    tokens: list[int]                      # generated ids (EOS included)
    n_prompt: int
    finish_reason: str                     # "stop" (EOS) | "length"
    ttft_s: float = 0.0                    # submit -> first token
    latency_s: float = 0.0                 # submit -> finished
    queue_s: float = 0.0                   # submit -> given a slot


@dataclass
class EngineStats:
    """Aggregate serving statistics, reported by ``ServeEngine.stats``."""

    requests_completed: int = 0
    prompt_tokens: int = 0
    generated_tokens: int = 0
    prefill_time_s: float = 0.0
    decode_time_s: float = 0.0
    decode_ticks: int = 0                  # fused-block invocations
    prefill_batches: int = 0               # slot-batched prefill launches
    admit_ticks: int = 0                   # ticks that admitted >= 1 request
                                           # (= shared first-token host syncs
                                           # under batched admission)
    slot_ticks_active: int = 0             # sum over ticks of active slots
    slot_ticks_total: int = 0              # ticks x slots (utilization denom)
    steps: int = 0                         # step() calls that ran work
    host_time_s: float = 0.0               # their wall time less their
                                           # waits in device readbacks
    ttft_s: list[float] = field(default_factory=list)
    latency_s: list[float] = field(default_factory=list)

    # ------------------------------------------------------------- derived
    @property
    def decode_tokens(self) -> int:
        """Tokens emitted by decode ticks (each active slot-tick emits
        exactly one); excludes the per-request first token, which prefill
        produces."""
        return self.slot_ticks_active

    @property
    def decode_tokens_per_s(self) -> float:
        return self.decode_tokens / self.decode_time_s \
            if self.decode_time_s > 0 else 0.0

    @property
    def total_time_s(self) -> float:
        return self.prefill_time_s + self.decode_time_s

    @property
    def tokens_per_s(self) -> float:
        return self.generated_tokens / self.total_time_s \
            if self.total_time_s > 0 else 0.0

    @property
    def mean_ttft_s(self) -> float:
        return sum(self.ttft_s) / len(self.ttft_s) if self.ttft_s else 0.0

    @property
    def mean_latency_s(self) -> float:
        return sum(self.latency_s) / len(self.latency_s) \
            if self.latency_s else 0.0

    @property
    def slot_utilization(self) -> float:
        return self.slot_ticks_active / self.slot_ticks_total \
            if self.slot_ticks_total else 0.0

    def as_dict(self) -> dict[str, Any]:
        return {
            "requests_completed": self.requests_completed,
            "prompt_tokens": self.prompt_tokens,
            "generated_tokens": self.generated_tokens,
            "prefill_time_s": self.prefill_time_s,
            "decode_time_s": self.decode_time_s,
            "decode_ticks": self.decode_ticks,
            "prefill_batches": self.prefill_batches,
            "admit_ticks": self.admit_ticks,
            "decode_tokens": self.decode_tokens,
            "decode_tokens_per_s": self.decode_tokens_per_s,
            "tokens_per_s": self.tokens_per_s,
            "mean_ttft_s": self.mean_ttft_s,
            "mean_latency_s": self.mean_latency_s,
            "slot_utilization": self.slot_utilization,
            "steps": self.steps,
            "host_time_s": self.host_time_s,
        }


OnToken = Callable[[int, int, int], None]  # (request_id, token, index)
