"""Utilities (counterpart of `paddle_tpu.utils`): step-indexed checkpoints
(`CheckpointManager`)."""
from .checkpoint import CheckpointManager

__all__ = ['CheckpointManager']
