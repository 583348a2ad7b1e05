"""Async, atomic checkpoints (``repro.checkpoint``)."""

from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
