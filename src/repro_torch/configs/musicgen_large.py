"""musicgen-large [audio]: 48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Backbone only (per assignment): the EnCodec tokenizer frontend is a stub;
``input_specs()`` provides precomputed frame embeddings.  Sinusoidal
absolute positions (rope='none'), LayerNorm + GELU per the MusicGen
transformer.
"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048,
    rope="none", norm="layernorm", mlp_act="gelu",
    frontend="audio",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=128, compute_dtype="float32")
