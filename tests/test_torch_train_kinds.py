"""The training loss and its gradients for the layer kinds beside
attn_mlp, fftconv_mlp and MoE (tests/test_torch_train.py holds those):
Mamba2 with zamba2's shared attention block, mLSTM/sLSTM, M-RoPE on
embedding inputs, sinusoidal positions on embedding inputs; against
jax.value_and_grad of the reference's loss_fn (repro.models.lm) on the
CPU, in float32, at the smoke configs' widths.

Tolerances as in tests/_lm_parity.py (``loss_parity``): the loss within
1e-5 of |ref|, each parameter's gradient within 1e-4 of that gradient's
max|ref|.
"""

import numpy as np
import pytest

from repro.models import frontend as rfrontend

from _lm_parity import loss_parity

B, S = 2, 16
# (name, smoke arch, changes, positions): zamba2 at its one shared place
# and with the shared block at two places (its gradient the sum over
# them), xlstm's mLSTM and sLSTM, qwen2-vl's patch embeddings on M-RoPE
# streams (a leading 3 x 3 image, then text), musicgen's frames
CASES = [
    ("zamba2", "zamba2_7b", {}, None),
    ("zamba2_two_places", "zamba2_7b",
     dict(num_layers=6, segments=(("mamba2", 2), ("shared_attn", 1),
                                  ("mamba2", 1), ("shared_attn", 1),
                                  ("mamba2", 1))), None),
    ("xlstm", "xlstm_1_3b", {}, None),
    ("qwen2_vl_embeds_mrope", "qwen2_vl_7b", {}, "mrope"),
    ("musicgen_embeds", "musicgen_large", {}, None),
]


@pytest.mark.parametrize("name,arch,changes,positions", CASES,
                         ids=[c[0] for c in CASES])
def test_loss_and_gradients_match_the_reference(name, arch, changes,
                                                positions):
    pos = (np.asarray(rfrontend.mrope_positions(B, S, 3))
           if positions == "mrope" else None)
    assert loss_parity(arch, changes, pos) == 0.0
