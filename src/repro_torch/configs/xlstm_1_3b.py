"""xlstm-1.3b [ssm]: 48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304 —
sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

Block layout: xLSTM[7:1] ratio — six repeats of (7 mLSTM + 1 sLSTM).
d_ff=0: mixers carry their own up/down projections (factor-2 for mLSTM).
Sub-quadratic (linear recurrence) => runs the long_500k cell.
"""

import dataclasses

from repro_torch.models.config import ArchConfig

_SEGMENTS = (("mlstm", 7), ("slstm", 1)) * 6

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    segments=_SEGMENTS, slstm_heads=4,
    rope="none", norm="rmsnorm",
    subquadratic=True, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, d_model=64, num_heads=4, num_kv_heads=4, vocab_size=512,
    num_layers=4, segments=(("mlstm", 3), ("slstm", 1)),
    compute_dtype="float32")
