"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064
— M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Backbone only (per assignment): the vision frontend is a stub;
``input_specs()`` provides precomputed patch embeddings plus the (3, B, S)
temporal/height/width M-RoPE position streams.
"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    rope="mrope", mrope_sections=(16, 24, 24), qkv_bias=True,
    norm="rmsnorm", mlp_act="silu",
    frontend="vision",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=56, num_heads=4, num_kv_heads=2,
    d_ff=112, vocab_size=512, mrope_sections=(3, 2, 2),
    compute_dtype="float32")
