"""Architecture configuration schema for the assigned-architecture pool,
a field-for-field copy of ``repro.models.config``."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # block layout: sequence of (kind, count) segments executed in order.
    # kinds: "attn_mlp" | "attn_moe" | "mlstm" | "slstm" | "mamba2" |
    #        "shared_attn" (single shared param set) | "fftconv_mlp"
    segments: Tuple[Tuple[str, int], ...] = ()

    # attention
    head_dim: Optional[int] = None    # default d_model // num_heads
    rope: str = "standard"            # standard | mrope | none
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    qkv_bias: bool = False
    parallel_block: bool = False      # command-r style parallel attn+FFN
    logit_softcap: float = 0.0

    # norm / misc
    norm: str = "rmsnorm"             # rmsnorm | layernorm | nonparam_ln
    tie_embeddings: bool = False
    mlp_act: str = "silu"             # silu (SwiGLU) | gelu (plain)

    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM / recurrent
    ssm_state: int = 0                # Mamba2 N
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    slstm_heads: int = 4

    # fftconv mixer (paper-technique ablation)
    fftconv_rank: int = 16

    # modality frontend stub ("vision" | "audio" | None): inputs are
    # precomputed embeddings, not token ids
    frontend: Optional[str] = None

    # whether full attention makes long_500k infeasible (quadratic): decides
    # the documented skip for the long-context cell
    subquadratic: bool = False

    # training details
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    # "full" = nothing_saveable (max recompute, min live memory);
    # "dots" = dots_with_no_batch_dims_saveable (keep matmul outputs,
    # recompute elementwise only — trades HBM residency for ~25% less
    # recompute flops; the granite train §Perf iteration)
    remat_policy: str = "full"
    # dtype of TP partial-sum reductions on out-projections (None = XLA
    # default, which all-reduces the f32 accumulator).  Serving sets
    # "bfloat16": halves cross-chip reduction bytes (§Perf hillclimb).
    reduce_dtype: str | None = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def resolved_segments(self) -> Tuple[Tuple[str, int], ...]:
        if self.segments:
            return self.segments
        kind = "attn_moe" if self.num_experts else "attn_mlp"
        return ((kind, self.num_layers),)

    def total_layers(self) -> int:
        return sum(n for _, n in self.resolved_segments())


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell from the assignment."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}
