"""The bfloat16 drift of the recurrent LMs at full depth: how far each
package's bfloat16 forward lies from its own float32 forward on the same
weights, for xlstm-1.3b (48 layers) and zamba2-7b (81) at d_model 256,
one sequence of 64 tokens.

At full width the card's bfloat16 logits of these two models lie far from
the float32 ones (chip_smoke.py phase 16 prints it). This test holds that
the drift is the models' and not the port's: the port's bfloat16 forward
is at most NOISE_RATIO times as far from float32 as the reference's, and
the two float32 forwards agree within 1e-4 of max|ref| (F32_TOL).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import lm as rlm
from repro_torch import configs as pconfigs
from repro_torch.convert import lm_from_reference

from _lm_parity import F32_TOL, f32, to_np

D, S, VOCAB = 256, 64, 512
NOISE_RATIO = 2.0           # chip_smoke.py's ratio between two bf16 orders
WIDTHS = {"xlstm_1_3b": {},
          "zamba2_7b": dict(d_ff=4 * D, num_heads=4, num_kv_heads=4,
                            ssm_state=64, ssm_head_dim=64)}


def _err(ours, ref):
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("arch", sorted(WIDTHS))
def test_bf16_drift_is_the_references(arch):
    changes = dict(d_model=D, vocab_size=VOCAB, param_dtype="float32",
                   **WIDTHS[arch])
    rc = dataclasses.replace(rconfigs.get_config(arch), **changes)
    pc = dataclasses.replace(pconfigs.get_config(arch), **changes)
    params = rlm.init_params(rc, jax.random.key(0))
    toks = np.random.default_rng(0).integers(0, VOCAB, (1, S))
    logits = {}
    for dtype in ("float32", "bfloat16"):
        r = dataclasses.replace(rc, compute_dtype=dtype)
        lg, _ = jax.jit(lambda p, b: rlm.forward(p, r, b))(
            params, {"tokens": jnp.asarray(toks)})
        logits["ref", dtype] = f32(lg)[..., :VOCAB]
        model = lm_from_reference(
            to_np(params), dataclasses.replace(pc, compute_dtype=dtype),
            device="cpu")
        with torch.no_grad():
            lg, _ = model({"tokens": torch.from_numpy(toks)})
        logits["port", dtype] = f32(lg)[..., :VOCAB]
    assert _err(logits["port", "float32"], logits["ref", "float32"]) <= F32_TOL
    ref = _err(logits["ref", "bfloat16"], logits["ref", "float32"])
    port = _err(logits["port", "bfloat16"], logits["port", "float32"])
    assert port <= NOISE_RATIO * ref, (port, ref)
