"""Optimizers of the port (``repro.optim`` counterpart)."""

from .optimizers import OptConfig, Optimizer, lr_schedule, make_optimizer

__all__ = ["OptConfig", "Optimizer", "lr_schedule", "make_optimizer"]
