"""Public API of the port: the :class:`Session` facade (training and
``serve()``), the :class:`SyncStrategy` registry, the sync policies, the
deprecated :class:`InferenceSession` shim and the serving names
re-exported from :mod:`repro_torch.serve` (``repro.api`` counterpart)."""

from ..core.sync_policies import (Int8EFSync, MeanSync, OuterOptSync,
                                  SyncPolicy, resolve_policy)
from ..serve import (Completion, EngineConfig, EngineStats, Request,
                     SamplingParams, ServeEngine)
from .registry import (available_strategies, get_strategy,
                       register_strategy, unregister_strategy)
from .session import InferenceSession, JobConfig, Session
from .strategies import SyncStrategy

__all__ = [
    "JobConfig", "Session", "InferenceSession",
    "SyncStrategy", "register_strategy", "get_strategy",
    "unregister_strategy", "available_strategies",
    "SyncPolicy", "MeanSync", "Int8EFSync", "OuterOptSync",
    "resolve_policy",
    # serving (re-exported from repro_torch.serve)
    "ServeEngine", "EngineConfig", "Request", "SamplingParams",
    "Completion", "EngineStats",
]
