"""The model stack of the port, ported from ``repro.models``: the config
schema, parameter metadata, the blocks (norms, RoPE and M-RoPE, GQA
attention, MLP, MoE, the FFT-convolution mixer), the recurrent mixers
(Mamba2, mLSTM, sLSTM), the frontend stand-ins and the decoder LM of every
layer kind."""

from . import blocks, frontend, lm, ssm
from .blocks import FFTConvMixer
from .config import (ArchConfig, ShapeConfig, SHAPES, SHAPES_BY_NAME,
                     TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
from .frontend import mrope_positions, synth_embeddings
from .lm import (LM, decode_step, forward, init_cache, init_params,
                 loss_fn, model_meta, prefill)
from .params import ParamMeta, init_tree, param_count

__all__ = [
    "blocks", "frontend", "lm", "ssm", "FFTConvMixer",
    "ArchConfig", "ShapeConfig", "SHAPES", "SHAPES_BY_NAME",
    "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
    "LM", "model_meta", "init_params", "forward", "loss_fn", "prefill",
    "init_cache",
    "decode_step", "mrope_positions", "synth_embeddings",
    "ParamMeta", "init_tree", "param_count",
]
