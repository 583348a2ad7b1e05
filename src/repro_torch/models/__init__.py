"""The model stack of the port, ported from ``repro.models``: the config
schema, parameter metadata, the blocks (norms, RoPE, GQA attention, MLP,
the FFT-convolution mixer) and the decoder LM of ``attn_mlp`` and
``fftconv_mlp`` layers."""

from . import blocks, lm
from .blocks import FFTConvMixer
from .config import (ArchConfig, ShapeConfig, SHAPES, SHAPES_BY_NAME,
                     TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
from .lm import (LM, decode_step, forward, init_cache, init_params,
                 model_meta, prefill)
from .params import ParamMeta, init_tree, param_count

__all__ = [
    "blocks", "lm", "FFTConvMixer",
    "ArchConfig", "ShapeConfig", "SHAPES", "SHAPES_BY_NAME",
    "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
    "LM", "model_meta", "init_params", "forward", "prefill", "init_cache",
    "decode_step", "ParamMeta", "init_tree", "param_count",
]
