"""Synthetic data pipeline, ported from ``repro.data.pipeline``:
deterministic and restartable.

Every batch is a pure function of (seed, step), so the iterator's state is
the step counter: a restart from a checkpoint resumes bit for bit. The
batches are the reference's numpy arrays, bit for bit (the same numpy
generator and calls). The reference's ``batch_specs`` and
``sharded_batch_at`` (each process materialises its shard of the global
batch) wait for the port of ``parallel/``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from ..models.config import ArchConfig, ShapeConfig


@dataclasses.dataclass
class SyntheticDataset:
    cfg: ArchConfig
    shape: ShapeConfig
    seed: int = 0

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, step))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Global (unsharded) numpy batch for ``step``."""
        rng = self._rng(step)
        b, s = self.shape.global_batch, self.shape.seq_len
        if self.shape.kind == "decode":
            s_tok = 1
        else:
            s_tok = s
        out: Dict[str, np.ndarray] = {}
        if self.cfg.frontend:
            out["embeds"] = (rng.standard_normal(
                (b, s_tok, self.cfg.d_model)).astype(np.float32) * 0.02)
        else:
            out["tokens"] = rng.integers(
                0, self.cfg.vocab_size, (b, s_tok), dtype=np.int32)
        if self.shape.kind in ("train", "prefill"):
            toks = out.get("tokens")
            if toks is not None:
                labels = np.concatenate(
                    [toks[:, 1:], np.full((b, 1), -1, np.int32)], axis=1)
            else:
                labels = rng.integers(0, self.cfg.vocab_size, (b, s_tok),
                                      dtype=np.int32)
            out["labels"] = labels
            if self.cfg.rope == "mrope":
                pos = np.broadcast_to(np.arange(s_tok, dtype=np.int32),
                                      (b, s_tok))
                out["positions"] = np.broadcast_to(
                    pos[None], (3, b, s_tok)).copy()
        return out
