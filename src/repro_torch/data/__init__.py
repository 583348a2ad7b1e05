"""Synthetic, restartable training data (``repro.data``)."""

from .pipeline import SyntheticDataset

__all__ = ["SyntheticDataset"]
