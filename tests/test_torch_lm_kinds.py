"""The LM of the layer kinds the port gained beside attn_mlp and
fftconv_mlp (MoE, Mamba2 with zamba2's shared attention, mLSTM/sLSTM,
M-RoPE from tokens), against the reference (repro.models.lm) on the CPU,
for the six smoke configs that use them, in float32. The blocks are held
in tests/test_torch_ssm.py and test_torch_moe_mrope.py, the embedding
inputs and bfloat16 in test_torch_lm_embeds.py.

Inputs are numpy arrays from a seed; the reference's weights come across
through ``convert.lm_from_reference`` and its caches through
``convert.cache_from_reference``. Tolerances as in tests/_lm_parity.py:
1e-4 of max|ref| in float32, 2e-2 in bfloat16, 2^-8 for bfloat16 caches;
float32 recurrent states at the compute tolerance.
"""

import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import lm as rlm
from repro.models.params import param_count as rparam_count
from repro_torch import configs as pconfigs
from repro_torch.convert import cache_from_reference, lm_from_reference
from repro_torch.models import LM, model_meta, param_count

from _lm_parity import (F32_TOL, cfgs, close, close_caches, reference_run, t,
                        to_np, vocab)

NEW_KINDS = ("phi35_moe_42b", "dbrx_132b", "xlstm_1_3b", "zamba2_7b",
             "qwen2_vl_7b", "musicgen_large")
B, S, NEW = 2, 12, 3


# -- the LM: parameters ------------------------------------------------------


@pytest.mark.parametrize("arch", NEW_KINDS)
def test_param_counts_and_names_follow_the_reference(arch):
    rc, pc = cfgs(arch)
    n = rparam_count(rlm.model_meta(rc))
    model = LM(pc, device="cpu", generator=torch.Generator().manual_seed(1))
    assert param_count(model_meta(pc)) == n
    assert sum(p.numel() for p in model.parameters()) == n
    # full size, no allocation
    assert param_count(model_meta(pconfigs.get_config(arch))) == \
        rparam_count(rlm.model_meta(rconfigs.get_config(arch)))
    names = dict(model.named_parameters())
    if arch == "zamba2_7b":
        # one shared block, at each of its places in the stack
        assert any(n.startswith("shared.") for n in names)
        shared = [i for i, layer in enumerate(model.layers)
                  if layer is model.shared]
        assert shared == [3] and not any(".3." in n for n in names)


# -- the LM: forward, prefill, decode against the reference ------------------


@pytest.fixture(scope="module")
def runs():
    """Per smoke config: the reference's forward, prefill and decode on
    tokens, and the port's LM on the same weights; computed once."""
    out = {}

    def get(arch):
        if arch not in out:
            rc, pc = cfgs(arch)
            toks = np.random.default_rng(1).integers(
                0, rc.vocab_size, (B, S + NEW)).astype(np.int32)
            out[arch] = reference_run(rc, pc, {"tokens": toks}, S, NEW)
        return out[arch]
    return get


def _tokens(r, lo, hi):
    return {"tokens": t(r["inputs"]["tokens"][:, lo:hi]).long()}


@pytest.mark.parametrize("arch", NEW_KINDS)
def test_lm_forward_matches_reference(runs, arch):
    r = runs(arch)
    with torch.no_grad():
        ours, aux = r["model"](_tokens(r, 0, S + NEW))
    assert ours.dtype == torch.float32 and aux.dtype == torch.float32
    close(vocab(r["pc"], ours), vocab(r["rc"], r["forward"]), r["tol"], arch)
    # the MoE aux loss, summed over the layers (0 for the others)
    assert abs(float(aux) - r["aux"]) <= F32_TOL * max(abs(r["aux"]), 1.0)
    assert (r["aux"] > 0) == (r["pc"].num_experts > 0)


@pytest.mark.parametrize("arch", NEW_KINDS)
def test_lm_prefill_matches_reference(runs, arch):
    r = runs(arch)
    lg, cache = r["model"].prefill(_tokens(r, 0, S), S + NEW)
    assert lg.dtype == torch.float32 and lg.shape[:2] == (B, 1)
    close(vocab(r["pc"], lg), vocab(r["rc"], r["prefill"]), r["tol"], arch)
    close_caches(cache, cache_from_reference(r["cache"], device="cpu"),
                  r["tol"], arch)


@pytest.mark.parametrize("arch", NEW_KINDS)
def test_lm_decode_steps_match_reference(runs, arch):
    r = runs(arch)
    model = r["model"]
    _, cache = model.prefill(_tokens(r, 0, S), S + NEW)
    for i, want in enumerate(r["steps"]):
        lg, cache = model.decode_step(cache, _tokens(r, S + i, S + i + 1))
        assert lg.dtype == torch.float32
        close(vocab(r["pc"], lg), vocab(r["rc"], want), r["tol"],
              f"{arch} step {i}")
    assert cache["len"].tolist() == [S + NEW] * B


@pytest.mark.parametrize("arch", NEW_KINDS)
def test_lm_decodes_from_the_reference_prefill_cache(runs, arch):
    r = runs(arch)
    cache = cache_from_reference(r["cache"], device="cpu")
    assert cache["len"].dtype == torch.int32
    for i, want in enumerate(r["steps"]):
        lg, cache = r["model"].decode_step(cache,
                                           _tokens(r, S + i, S + i + 1))
        close(vocab(r["pc"], lg), vocab(r["rc"], want), r["tol"],
              f"{arch} step {i}")


@pytest.mark.parametrize("arch", ["zamba2_7b", "xlstm_1_3b"])
def test_init_cache_is_the_references(arch):
    rc, pc = cfgs(arch)
    model = LM(pc, device="cpu")
    want = cache_from_reference(to_np(rlm.init_cache(rc, 3, 10)),
                                device="cpu")
    close_caches(model.init_cache(3, 10), want, 0.0, arch)


def test_decode_continues_forward_for_recurrent_kinds(runs):
    # within the port, xlstm (rope none: sinusoid at len): the decode
    # steps after a prefill give forward's rows
    r = runs("xlstm_1_3b")
    with torch.no_grad():
        full, _ = r["model"](_tokens(r, 0, S + NEW))
    _, cache = r["model"].prefill(_tokens(r, 0, S), S + NEW)
    for i in range(NEW - 1):
        lg, cache = r["model"].decode_step(cache,
                                           _tokens(r, S + i, S + i + 1))
        close(vocab(r["pc"], lg[:, 0]), vocab(r["pc"], full[:, S + i]),
              F32_TOL, f"step {i}")


def test_conversions_of_the_new_kinds_raise_on_a_mismatch(runs):
    r = runs("zamba2_7b")
    bad = dict(r["params"])
    del bad["shared"]
    with pytest.raises(ValueError, match="shared"):
        lm_from_reference(bad, r["pc"], device="cpu")
    seg = dict(r["cache"]["segments"][0])
    seg["ssm_extra"] = seg["ssd"]
    with pytest.raises(ValueError, match="a segment cache"):
        cache_from_reference({"len": r["cache"]["len"], "segments": [seg]},
                             device="cpu")
    with pytest.raises(ValueError, match="a segment cache"):
        cache_from_reference({"len": r["cache"]["len"], "segments": [{}]},
                             device="cpu")
