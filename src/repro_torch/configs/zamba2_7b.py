"""zamba2-7b [hybrid]: 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks [arXiv:2411.15242;
unverified].

Block layout: 81 blocks total — (6 Mamba2 + 1 shared-attention) x 11 + 4
Mamba2.  The shared attention+MLP block reuses ONE parameter set at all 11
occurrences (the Zamba weight-sharing trick); each occurrence owns its KV
cache.  Mamba2 backbone => sub-quadratic, runs the long_500k cell.
"""

import dataclasses

from repro_torch.models.config import ArchConfig

_SEGMENTS = (("mamba2", 6), ("shared_attn", 1)) * 11 + (("mamba2", 4),)

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    segments=_SEGMENTS,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    rope="standard", norm="rmsnorm", mlp_act="silu",
    subquadratic=True,
)

SMOKE = dataclasses.replace(
    CONFIG, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=512, ssm_state=16, ssm_head_dim=8, num_layers=7,
    segments=(("mamba2", 3), ("shared_attn", 1), ("mamba2", 3)),
    compute_dtype="float32")
