"""Utilities (counterpart of `paddle_tpu.utils`): step-indexed checkpoints
(`CheckpointManager`) and the JSONL metric log (`logging.SummaryWriter`)."""
from . import logging
from .checkpoint import CheckpointManager

__all__ = ['CheckpointManager', 'logging']
