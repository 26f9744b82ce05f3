"""Public API of the port: the :class:`Session` facade (training and
``serve()``), the :class:`SyncStrategy` registry and the deprecated
:class:`InferenceSession` shim (``repro.api`` counterpart)."""

from ..core.sync_policies import (Int8EFSync, MeanSync, OuterOptSync,
                                  SyncPolicy)
from .registry import (available_strategies, get_strategy,
                       register_strategy, unregister_strategy)
from .session import InferenceSession, JobConfig, Session
from .strategies import SyncStrategy

__all__ = ["JobConfig", "Session", "InferenceSession", "SyncStrategy",
           "SyncPolicy", "MeanSync", "Int8EFSync", "OuterOptSync",
           "available_strategies", "get_strategy", "register_strategy",
           "unregister_strategy"]
