"""The training driver (``repro.runtime``)."""

from .trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig"]
