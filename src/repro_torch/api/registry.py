"""Pluggable :class:`~repro_torch.api.strategies.SyncStrategy` registry.

Framework-free copy of ``repro.api.registry``.

The synchronization algorithm is an extension point, not a string table:
anything that can build a :class:`~repro_torch.core.plans.SyncPlan` from a
:class:`~repro_torch.core.profiler.LayerProfile` — and optionally pick a
:class:`~repro_torch.core.sync_policies.SyncPolicy` for its syncs — can be
registered and then used anywhere an ``algo`` name is accepted
(:class:`~repro_torch.api.Session`, :func:`repro_torch.core.plans.build_plan`, the
``--algo`` CLI flag, benchmarks).

Register with the decorator form::

    from repro_torch.api import SyncStrategy, register_strategy

    @register_strategy("my-algo")
    class MyAlgo(SyncStrategy):
        def build_plan(self, profile, H, *, fill_mode="exact"):
            ...

or imperatively for parameterized instances::

    register_strategy("dreamddp-lazy", DreamDDP(fill_default="off"))

Built-in strategies (the paper's six plus beyond-paper compositions) are
defined in :mod:`repro_torch.api.strategies` and loaded on first lookup.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["register_strategy", "get_strategy", "unregister_strategy",
           "available_strategies"]

_REGISTRY: dict[str, object] = {}
_builtins_loaded = False


def _ensure_builtins() -> None:
    global _builtins_loaded
    if not _builtins_loaded:
        _builtins_loaded = True
        from . import strategies  # noqa: F401  (registers the built-ins)


def register_strategy(name: str, strategy: object | None = None
                      ) -> object | Callable:
    """Register a strategy under ``name``; decorator and imperative forms.

    Classes are instantiated with no arguments; instances are stored as-is.
    The stored instance's ``name`` attribute is forced to the registered
    name so ``get_strategy(name).name == name`` always holds.
    """
    if not name or not isinstance(name, str):
        raise ValueError(f"strategy name must be a non-empty str: {name!r}")
    if strategy is None:
        def deco(obj):
            register_strategy(name, obj)
            return obj
        return deco

    instance = strategy() if isinstance(strategy, type) else strategy
    if not callable(getattr(instance, "build_plan", None)):
        raise TypeError(f"{instance!r} does not implement build_plan() — "
                        f"not a SyncStrategy")
    if getattr(instance, "name", None) != name:
        try:
            object.__setattr__(instance, "name", name)  # frozen dataclasses
        except (AttributeError, TypeError):
            instance.name = name
    _REGISTRY[name] = instance
    return strategy


def get_strategy(name: str):
    """Look up a registered strategy (KeyError with suggestions if absent)."""
    _ensure_builtins()
    if name not in _REGISTRY:
        raise KeyError(f"unknown sync strategy {name!r}; available: "
                       f"{available_strategies()}")
    return _REGISTRY[name]


def unregister_strategy(name: str) -> None:
    """Remove a strategy (primarily for tests)."""
    _REGISTRY.pop(name, None)


def available_strategies() -> tuple[str, ...]:
    """Sorted names of every registered strategy."""
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))
