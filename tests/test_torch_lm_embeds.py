"""The port's LM on embedding inputs (the frontends' contract: musicgen's
frames, qwen2-vl's patches with M-RoPE position streams) and in bfloat16
compute, against the reference (repro.models.lm) on the CPU, at the smoke
configs' widths.

Inputs are numpy arrays from a seed; the reference's weights come across
through ``convert.lm_from_reference``. Tolerances as in
tests/_lm_parity.py: 1e-4 of max|ref| in float32, 2e-2 in bfloat16 (every
activation rounded to 8 bits); caches as ``close_caches`` holds them.
"""

import numpy as np
import pytest
import torch

from repro.models import frontend as rfrontend
from repro_torch.convert import cache_from_reference

from _lm_parity import batch, cfgs, close, close_caches, f32, reference_run, \
    vocab

B, S, NEW = 2, 12, 3
BF16 = dict(compute_dtype="bfloat16")
# (name, smoke arch, changes, inputs): embeddings with and without M-RoPE
# streams (a leading 3 x 3 grid of patches, then text), and the recurrent,
# hybrid and MoE stacks in bfloat16
CASES = [
    ("musicgen_embeds", "musicgen_large", {}, "embeds"),
    ("musicgen_embeds_bf16", "musicgen_large", BF16, "embeds"),
    ("qwen2_vl_embeds_mrope", "qwen2_vl_7b", {}, "embeds+mrope"),
    ("qwen2_vl_embeds_mrope_bf16", "qwen2_vl_7b", BF16, "embeds+mrope"),
    ("qwen2_vl_tokens_mrope", "qwen2_vl_7b", {}, "tokens+mrope"),
    ("xlstm_bf16", "xlstm_1_3b", BF16, "tokens"),
    ("zamba2_bf16", "zamba2_7b", BF16, "tokens"),
    ("phi35_moe_bf16", "phi35_moe_42b", BF16, "tokens"),
]
NAMES = [c[0] for c in CASES]


def _inputs(rc, kind):
    rng = np.random.default_rng(2)
    if kind.startswith("embeds"):
        out = {"embeds": (0.02 * rng.standard_normal(
            (B, S + NEW, rc.d_model))).astype(np.float32)}
    else:
        out = {"tokens": rng.integers(0, rc.vocab_size,
                                      (B, S + NEW)).astype(np.int32)}
    if kind.endswith("mrope"):
        out["positions"] = np.asarray(rfrontend.mrope_positions(
            B, S + NEW, 3))
    return out


@pytest.fixture(scope="module")
def runs():
    out = {}

    def get(name):
        if name not in out:
            _, arch, changes, kind = next(c for c in CASES if c[0] == name)
            rc, pc = cfgs(arch, **changes)
            out[name] = reference_run(rc, pc, _inputs(rc, kind), S, NEW)
        return out[name]
    return get


@pytest.mark.parametrize("name", NAMES)
def test_lm_forward_matches_reference(runs, name):
    r = runs(name)
    with torch.no_grad():
        ours, _ = r["model"](batch(r["inputs"], 0, S + NEW, "torch"))
    assert ours.dtype == getattr(torch, r["pc"].compute_dtype)
    close(vocab(r["pc"], ours), vocab(r["rc"], r["forward"]), r["tol"], name)


@pytest.mark.parametrize("name", NAMES)
def test_lm_prefill_matches_reference(runs, name):
    r = runs(name)
    lg, cache = r["model"].prefill(batch(r["inputs"], 0, S, "torch"), S + NEW)
    close(vocab(r["pc"], lg), vocab(r["rc"], r["prefill"]), r["tol"], name)
    close_caches(cache, cache_from_reference(r["cache"], device="cpu"),
                 r["tol"], name)


@pytest.mark.parametrize("name", NAMES)
def test_lm_decode_steps_match_reference(runs, name):
    # decode gives a token the position len in all three M-RoPE streams,
    # as the reference does, whatever layout the prefill had
    r = runs(name)
    model = r["model"]
    _, cache = model.prefill(batch(r["inputs"], 0, S, "torch"), S + NEW)
    for i, want in enumerate(r["steps"]):
        one = batch(r["inputs"], S + i, S + i + 1, "torch")
        one.pop("positions", None)
        lg, cache = model.decode_step(cache, one)
        close(vocab(r["pc"], lg), vocab(r["rc"], want), r["tol"],
              f"{name} step {i}")


def test_mrope_layout_changes_the_logits(runs):
    # the image prefix's (t, h, w) streams are not the text positions: the
    # prefill moves by 10x the tolerance it is held to
    r = runs("qwen2_vl_embeds_mrope")
    plain = {k: v for k, v in batch(r["inputs"], 0, S, "torch").items()
             if k != "positions"}
    lg, _ = r["model"].prefill(plain, S + NEW)
    assert np.abs(f32(lg) - f32(r["prefill"])).max() > \
        10 * r["tol"] * np.abs(f32(r["prefill"])).max()
