"""Synthetic data pipeline, ported from ``repro.data.pipeline``:
deterministic and restartable.

Every batch is a pure function of (seed, step), so the iterator's state is
the step counter: a restart from a checkpoint resumes bit for bit. The
batches are the reference's numpy arrays, bit for bit (the same numpy
generator and calls). On a mesh each rank materialises its rows of the
global batch (``sharded_batch_at``, laid out by ``batch_specs``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from ..models.config import ArchConfig, ShapeConfig


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, rules: Dict) -> Dict:
    """Specs for one batch (one mesh-axis entry per dim): the batch dim
    over ``dp``."""
    dp = rules.get("dp")
    if shape.kind == "train" or shape.kind == "prefill":
        if cfg.frontend:
            specs = {"embeds": (dp, None, None), "labels": (dp, None)}
        else:
            specs = {"tokens": (dp, None), "labels": (dp, None)}
        if cfg.rope == "mrope":
            specs["positions"] = (None, dp, None)
        return specs
    # decode: one token per sequence
    if cfg.frontend:
        return {"embeds": (dp, None, None)}
    return {"tokens": (dp, None)}


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

    def sharded_batch_at(self, step: int, mesh,
                         rules: Dict) -> Dict[str, np.ndarray]:
        """This rank's block of ``batch_at(step)`` by ``batch_specs``: rank
        r of the ``dp`` axes (row-major over a tuple) holds rows r*B/dp
        onwards (of every M-RoPE position stream). A batch the ``dp`` ranks
        do not divide raises."""
        from ..parallel.rules import NamedSharding, mesh_shape
        from ..models.params import axes_size
        specs = batch_specs(self.cfg, self.shape, rules)
        dp = axes_size(mesh_shape(mesh), rules.get("dp"))
        if self.shape.global_batch % dp:
            raise ValueError(f"a batch of {self.shape.global_batch} over "
                             f"{dp} data ranks")
        out: Dict[str, Any] = {}
        for k, arr in self.batch_at(step).items():
            out[k] = np.ascontiguousarray(
                NamedSharding(mesh, specs[k]).shard(arr))
        return out
