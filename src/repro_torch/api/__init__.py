"""Public API of the port's training side: the :class:`Session` facade and
the :class:`SyncStrategy` registry (``repro.api`` counterpart)."""

from ..core.sync_policies import (Int8EFSync, MeanSync, OuterOptSync,
                                  SyncPolicy)
from .registry import (available_strategies, get_strategy,
                       register_strategy, unregister_strategy)
from .session import JobConfig, Session
from .strategies import SyncStrategy

__all__ = ["JobConfig", "Session", "SyncStrategy", "SyncPolicy", "MeanSync",
           "Int8EFSync", "OuterOptSync", "available_strategies",
           "get_strategy", "register_strategy", "unregister_strategy"]
