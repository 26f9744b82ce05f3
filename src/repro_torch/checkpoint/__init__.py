"""Checkpoints of training state (``repro.checkpoint`` counterpart)."""

from .manager import CheckpointManager, reshard_workers

__all__ = ["CheckpointManager", "reshard_workers"]
