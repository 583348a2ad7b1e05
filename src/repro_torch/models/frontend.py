"""The modality frontend stand-ins, ported from ``repro.models.frontend``.

The vision (qwen2-vl) and audio (musicgen) configs specify the transformer
backbone only: a real deployment runs a ViT patch encoder or an EnCodec
quantizer in front of it. Here the frontend's contract is the embedding
tensor it hands the backbone (``{"embeds": (B, S, d)}`` batches of
``models.lm.LM``) and, for vision, the M-RoPE position streams.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.plan import resolve_device
from .config import ArchConfig


def synth_embeddings(cfg: ArchConfig, batch: int, seq: int,
                     generator: torch.Generator, device=None) -> torch.Tensor:
    """Stand-in for the frontend's output: (B, S, d) embeddings in the
    compute dtype, a standard normal drawn in float32 on the generator's
    device, cast, and scaled by 0.02 (in the compute dtype, as the
    reference scales it), on ``device`` (None: the GPU)."""
    x = torch.randn((batch, seq, cfg.d_model), generator=generator,
                    device=generator.device, dtype=torch.float32)
    x = x.to(device=resolve_device(device),
             dtype=getattr(torch, cfg.compute_dtype))
    return x * 0.02


def mrope_positions(batch: int, seq: int, grid_hw: int = 16,
                    device=None) -> torch.Tensor:
    """(3, B, S) int32 temporal/height/width position streams for M-RoPE,
    on ``device`` (None: the GPU).

    The reference's synthetic layout: a leading image of grid_hw x grid_hw
    patches (t = 0, h and w its row and column) followed by text tokens,
    whose three streams all count on from grid_hw (qwen2-vl's
    dynamic-resolution order, fixed here)."""
    n_img = min(grid_hw * grid_hw, seq)
    t = np.zeros(seq, np.int32)
    h = np.zeros(seq, np.int32)
    w = np.zeros(seq, np.int32)
    h[:n_img] = np.arange(n_img) // grid_hw
    w[:n_img] = np.arange(n_img) % grid_hw
    text_pos = np.arange(seq - n_img) + (n_img // grid_hw)
    t[n_img:] = text_pos
    h[n_img:] = text_pos
    w[n_img:] = text_pos
    pos = np.stack([t, h, w])                                   # (3, S)
    pos = np.broadcast_to(pos[:, None], (3, batch, seq)).copy()
    return torch.from_numpy(pos).to(resolve_device(device))
