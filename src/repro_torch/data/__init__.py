"""Synthetic, restartable training data (``repro.data``)."""

from .pipeline import SyntheticDataset, batch_specs

__all__ = ["SyntheticDataset", "batch_specs"]
