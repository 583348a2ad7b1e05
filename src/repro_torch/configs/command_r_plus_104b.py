"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8) d_ff=33792
vocab=256000 — GQA, no-bias, parallel attn+FFN blocks
[hf:CohereForAI/c4ai-command-r-v01; unverified]."""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b", family="dense",
    num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8,
    d_ff=33792, vocab_size=256000,
    rope="standard", norm="layernorm", mlp_act="silu",
    parallel_block=True,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=96, num_heads=6, num_kv_heads=2,
    d_ff=192, vocab_size=512, compute_dtype="float32")
