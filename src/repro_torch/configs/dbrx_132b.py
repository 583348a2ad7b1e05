"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4, fine-grained [hf:databricks/dbrx-base; unverified]."""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=10752, vocab_size=100352,
    num_experts=16, top_k=4,
    rope="standard", norm="layernorm", mlp_act="silu",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=96, num_heads=6, num_kv_heads=2,
    d_ff=144, vocab_size=512, num_experts=4, top_k=2,
    compute_dtype="float32")
