"""The port's model stack (repro_torch.models: config, params, blocks, lm;
repro_torch.configs) against the reference's (repro.models, repro.configs)
on the CPU, at the smoke configs' widths.

Inputs are numpy arrays from a seed; the reference's weights come across
through ``convert.lm_from_reference``, so both packages compute with the
same numbers. Tolerances, each of max|ref|:

* float32 compute: 1e-4 (float32 arithmetic in another order);
* bfloat16 compute: 2e-2 (every activation is rounded to 8 bits, as the
  reference's own serving test allows: tests/test_serving.py);
* decode caches (stored in bfloat16 by both): 2^-8, one bfloat16 rounding
  step, which a float32 difference of one ulp before the cast can flip.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import blocks as rb
from repro.models import lm as rlm
from repro.models.params import init_tree as rinit_tree
from repro.models.params import param_count as rparam_count
from repro_torch import configs as pconfigs
from repro_torch.convert import cache_from_reference, lm_from_reference
from repro_torch.models import LM, blocks as pb, model_meta, param_count
from repro_torch.models.lm import padded_vocab

F32_TOL, BF16_TOL, CACHE_TOL = 1e-4, 2e-2, 2.0 ** -8
RNG = np.random.default_rng(17)

DENSE = ("olmo_1b", "granite_8b", "granite_3_2b", "command_r_plus_104b")
# (name, smoke arch, changes): the dense smoke configs, the FFT-conv LM at
# the olmo smoke width, a hybrid, absolute positions, and bfloat16 compute
CASES = [(a, a, {}) for a in DENSE] + [
    ("fftconv", "olmo_1b", dict(segments=(("fftconv_mlp", 2),))),
    ("hybrid", "olmo_1b", dict(segments=(("attn_mlp", 1),
                                         ("fftconv_mlp", 1)))),
    ("rope_none", "olmo_1b", dict(rope="none")),
    ("fftconv_bf16", "olmo_1b", dict(segments=(("attn_mlp", 1),
                                               ("fftconv_mlp", 1)),
                                     compute_dtype="bfloat16")),
]
B, S, NEW = 2, 12, 3


def _cfgs(arch, **changes):
    """(the reference's config, the port's), both with ``changes``."""
    return (dataclasses.replace(rconfigs.get_smoke_config(arch), **changes),
            dataclasses.replace(pconfigs.get_smoke_config(arch), **changes))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _close(ours, theirs, rel, what=""):
    ours = np.asarray(ours.float() if torch.is_tensor(ours) else ours,
                      np.float32)
    theirs = np.asarray(theirs, np.float32)
    assert ours.shape == theirs.shape, (what, ours.shape, theirs.shape)
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=rel * np.abs(theirs).max(), err_msg=what)


# -- configs and parameters -------------------------------------------------


@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_configs_are_the_references(arch):
    for get in ("get_config", "get_smoke_config"):
        ours = getattr(pconfigs, get)(arch)
        theirs = getattr(rconfigs, get)(arch)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.hd == theirs.hd
        assert ours.resolved_segments() == theirs.resolved_segments()
    assert pconfigs.ARCH_IDS == rconfigs.ARCH_IDS
    assert pconfigs.ALIASES == rconfigs.ALIASES
    for alias in (a for a, m in rconfigs.ALIASES.items() if m == arch):
        assert pconfigs.get_config(alias) == pconfigs.get_config(arch)


@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_every_smoke_config_builds(arch):
    cfg = pconfigs.get_smoke_config(arch)
    assert pconfigs.all_configs()[arch] == pconfigs.get_config(arch)
    model = LM(cfg, device="cpu")
    assert len(model.layers) == cfg.total_layers()
    assert [layer.kind for layer in model.layers] == [
        kind for kind, count in cfg.resolved_segments() for _ in range(count)]


def test_an_unknown_layer_kind_raises():
    cfg = dataclasses.replace(pconfigs.get_smoke_config("olmo_1b"),
                              segments=(("attn_mlp", 1), ("rwkv", 1)))
    with pytest.raises(ValueError, match="unknown block kind 'rwkv'"):
        LM(cfg, device="cpu")


@pytest.mark.parametrize("arch,changes", [(a, {}) for a in DENSE] + [
    ("olmo_1b", dict(segments=(("fftconv_mlp", 2),))),
    ("olmo_1b", dict(param_dtype="bfloat16"))])
def test_param_count_and_init_follow_the_reference(arch, changes):
    rc, pc = _cfgs(arch, **changes)
    n = rparam_count(rlm.model_meta(rc))
    model = LM(pc, device="cpu", generator=torch.Generator().manual_seed(1))
    params = {n: p.detach() for n, p in model.named_parameters()}
    assert param_count(model_meta(pc)) == n
    assert sum(p.numel() for p in params.values()) == n
    want = getattr(torch, pc.param_dtype)
    assert all(p.dtype == want for p in params.values())
    # the initialisation rules: ones, zeros, normal x scale
    for name, p in params.items():
        if name.endswith(("ln1.scale", "ln2.scale", "skip")):
            assert torch.equal(p, torch.ones_like(p)), name
        elif name.endswith("bias"):
            assert torch.equal(p, torch.zeros_like(p)), name
    scale = 0.02 / np.sqrt(pc.d_model)
    if "lm_head" in params:
        assert abs(float(params["lm_head"].float().std()) / scale - 1) < 0.1
    assert abs(float(params["embed"].float().std()) / 0.02 - 1) < 0.1


def test_full_size_param_counts():
    # olmo-1b as published and the FFT-conv LM at its width (no allocation)
    olmo = pconfigs.get_config("olmo-1b")
    fftconv = dataclasses.replace(olmo, segments=(("fftconv_mlp", 16),))
    for cfg in (olmo, fftconv):
        assert param_count(model_meta(cfg)) == rparam_count(
            rlm.model_meta(rconfigs.get_config("olmo-1b") if cfg is olmo
                           else dataclasses.replace(
                               rconfigs.get_config("olmo-1b"),
                               segments=(("fftconv_mlp", 16),))))
    assert padded_vocab(olmo) == 50432
    assert param_count(model_meta(olmo)) == 1_177_026_560
    assert param_count(model_meta(fftconv)) == 1_110_474_752


# -- blocks -----------------------------------------------------------------


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_norms_match_reference(norm):
    rc, pc = _cfgs("granite_8b", norm=norm)
    p = {k: (RNG.standard_normal(m.shape) * 0.5 + 1).astype(np.float32)
         for k, m in rb.norm_meta(rc).items()}
    assert set(p) == set(pb.norm_meta(pc))
    x = (RNG.standard_normal((2, 5, rc.d_model)) * 3 + 1).astype(np.float32)
    theirs = rb.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, rc,
                           jnp.asarray(x))
    ours = pb.apply_norm({k: _t(v) for k, v in p.items()}, pc, _t(x))
    _close(ours, theirs, F32_TOL)


def test_rope_matches_reference():
    rc, pc = _cfgs("granite_8b")
    positions = (np.arange(7)[None] + np.array([[0], [40]])).astype(np.int32)
    cos_r, sin_r = rb.rope_tables(rc, jnp.asarray(positions))
    cos_p, sin_p = pb.rope_tables(pc, _t(positions))
    _close(cos_p, cos_r, F32_TOL)
    _close(sin_p, sin_r, F32_TOL)
    x = RNG.standard_normal((2, 7, 4, pc.hd)).astype(np.float32)
    _close(pb.apply_rope(_t(x), cos_p, sin_p),
           rb.apply_rope(jnp.asarray(x), cos_r, sin_r), F32_TOL)
    assert pb.rope_tables(dataclasses.replace(pc, rope="none"),
                          _t(positions)) is None
    # M-RoPE of text-only positions drives its three streams alike: RoPE
    mrope = pb.rope_tables(dataclasses.replace(
        pc, rope="mrope", mrope_sections=(pc.hd // 2 - 2, 1, 1)),
        _t(positions))
    assert torch.equal(mrope[0], cos_p) and torch.equal(mrope[1], sin_p)


@pytest.mark.parametrize("sk,block_kv,causal,q_offset,dtype", [
    (16, 4, True, 0, "float32"),      # four chunks
    (12, 5, True, 0, "float32"),      # 5 does not divide 12: blocks of 4
    (13, 4, True, 0, "float32"),      # a prime length: blocks of 1
    (12, 8, False, 0, "float32"),
    (12, 4, True, 3, "float32"),      # queries offset into the keys
    (16, 4, True, 0, "bfloat16"),
])
def test_flash_attention_matches_reference(sk, block_kv, causal, q_offset,
                                           dtype):
    sq = sk - q_offset
    q = RNG.standard_normal((2, sq, 4, 8)).astype(np.float32)
    k = RNG.standard_normal((2, sk, 2, 8)).astype(np.float32)
    v = RNG.standard_normal((2, sk, 2, 8)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    theirs = rb.flash_attention(*(jnp.asarray(a, jd) for a in (q, k, v)),
                                causal=causal, block_kv=block_kv,
                                q_offset=q_offset)
    ours = pb.flash_attention(*(_t(a, td) for a in (q, k, v)),
                              causal=causal, block_kv=block_kv,
                              q_offset=q_offset)
    assert ours.dtype == td
    _close(ours, np.asarray(theirs.astype(jnp.float32)),
           F32_TOL if dtype == "float32" else BF16_TOL)
    # one block: the plain softmax of the reference's decode attention
    whole = pb.flash_attention(*(_t(a, td) for a in (q, k, v)),
                               causal=causal, block_kv=sk, q_offset=q_offset)
    _close(ours, whole.float().numpy(),
           F32_TOL if dtype == "float32" else BF16_TOL)


def _attention_params(rc, seed):
    p = _np(rinit_tree(rb.attention_meta(rc), jax.random.key(seed)))
    return {k: (v + 0.1 * RNG.standard_normal(v.shape)).astype(np.float32)
            if k.startswith("b") else v for k, v in p.items()}


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_attention_fwd_without_a_cache_matches_reference(qkv_bias):
    rc, pc = _cfgs("granite_8b", qkv_bias=qkv_bias)
    p = _attention_params(rc, 3)
    x = RNG.standard_normal((2, 9, rc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9)[None], (2, 9)).astype(np.int32)
    theirs, c = rb.attention_fwd({k: jnp.asarray(v) for k, v in p.items()},
                                 rc, jnp.asarray(x), jnp.asarray(pos))
    ours, oc = pb.attention_fwd({k: _t(v) for k, v in p.items()}, pc, _t(x),
                                _t(pos))
    assert c is None and oc is None
    _close(ours, theirs, F32_TOL)


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_attention_fwd_with_a_cache_matches_reference(qkv_bias):
    rc, pc = _cfgs("granite_8b", qkv_bias=qkv_bias)
    p = _attention_params(rc, 4)
    s_max, kv, hd = 10, rc.num_kv_heads, rc.hd
    kc = RNG.standard_normal((2, s_max, kv, hd)).astype(np.float32)
    vc = RNG.standard_normal((2, s_max, kv, hd)).astype(np.float32)
    # row 1's index is past the end: dynamic_update_slice clamps it
    lens = np.array([3, s_max], np.int32)
    x = RNG.standard_normal((2, 1, rc.d_model)).astype(np.float32)
    theirs, c = rb.attention_fwd(
        {k: jnp.asarray(v) for k, v in p.items()}, rc, jnp.asarray(x),
        jnp.asarray(lens[:, None]),
        {"k": jnp.asarray(kc, jnp.bfloat16), "v": jnp.asarray(vc, jnp.bfloat16),
         "len": jnp.asarray(lens)})
    ours, oc = pb.attention_fwd(
        {k: _t(v) for k, v in p.items()}, pc, _t(x), _t(lens[:, None]),
        {"k": _t(kc, torch.bfloat16), "v": _t(vc, torch.bfloat16),
         "len": _t(lens)})
    _close(ours, theirs, F32_TOL)
    for name in ("k", "v"):
        assert oc[name].dtype == torch.bfloat16
        _close(oc[name], np.asarray(c[name].astype(jnp.float32)), CACHE_TOL)
    assert np.array_equal(oc["len"].numpy(), np.asarray(c["len"]))


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_reference(act, dtype):
    rc, pc = _cfgs("granite_8b", mlp_act=act)
    p = _np(rinit_tree(rb.mlp_meta(rc), jax.random.key(5)))
    assert set(p) == set(pb.mlp_meta(pc))
    x = RNG.standard_normal((2, 6, rc.d_model)).astype(np.float32)
    theirs = rb.mlp_fwd({k: jnp.asarray(v) for k, v in p.items()}, rc,
                        jnp.asarray(x, getattr(jnp, dtype)))
    ours = pb.mlp_fwd({k: _t(v) for k, v in p.items()}, pc,
                      _t(x, getattr(torch, dtype)))
    assert ours.dtype == getattr(torch, dtype)
    _close(ours, np.asarray(theirs.astype(jnp.float32)),
           F32_TOL if dtype == "float32" else BF16_TOL)


def test_fftconv_decode_matches_reference():
    from repro_torch.convert import fftconv_mixer_from_reference
    rc, pc = _cfgs("olmo_1b")
    p = _np(rinit_tree(rb.fftconv_meta(rc), jax.random.key(6)))
    s_max, d = 16, rc.d_model
    hist = RNG.standard_normal((3, s_max, d)).astype(np.float32)
    pos = np.array([0, 7, s_max - 1], np.int32)
    x = RNG.standard_normal((3, 1, d)).astype(np.float32)
    theirs, th = rb.fftconv_decode({k: jnp.asarray(v) for k, v in p.items()},
                                   rc, jnp.asarray(x),
                                   jnp.asarray(hist, jnp.bfloat16),
                                   jnp.asarray(pos))
    mixer = fftconv_mixer_from_reference(p, device="cpu")
    with torch.no_grad():
        ours, oh = mixer.decode(_t(x), _t(hist, torch.bfloat16), _t(pos))
    _close(ours, theirs, F32_TOL)
    _close(oh, np.asarray(th.astype(jnp.float32)), CACHE_TOL)


# -- the LM: forward, prefill, decode --------------------------------------


@pytest.fixture(scope="module")
def runs():
    """Per case: the reference's forward, prefill and decode, and the
    port's LM on the same weights; computed once for the tests below."""
    out = {}

    def get(name):
        if name in out:
            return out[name]
        _, arch, changes = next(c for c in CASES if c[0] == name)
        rc, pc = _cfgs(arch, **changes)
        params = rlm.init_params(rc, jax.random.key(0))
        rng = np.random.default_rng(1)
        toks = rng.integers(0, rc.vocab_size, (B, S + NEW)).astype(np.int32)
        full, _ = jax.jit(lambda p, b: rlm.forward(p, rc, b))(
            params, {"tokens": jnp.asarray(toks)})
        lg, cache = jax.jit(lambda p, b: rlm.prefill(p, rc, b, S + NEW))(
            params, {"tokens": jnp.asarray(toks[:, :S])})
        ref_cache = _np(cache)
        step = jax.jit(lambda p, c, b: rlm.decode_step(p, rc, c, b))
        steps = []
        for i in range(NEW):
            lg2, cache = step(params, cache,
                              {"tokens": jnp.asarray(toks[:, S + i:][:, :1])})
            steps.append(np.asarray(lg2))
        out[name] = dict(
            rc=rc, pc=pc, toks=toks, params=_np(params),
            forward=np.asarray(full.astype(jnp.float32)),
            prefill=np.asarray(lg), cache=ref_cache, steps=steps,
            model=lm_from_reference(_np(params), pc, device="cpu"),
            tol=F32_TOL if rc.compute_dtype == "float32" else BF16_TOL)
        return out[name]
    return get


NAMES = [c[0] for c in CASES]


def _vocab(r, a):
    """The first vocab_size columns; the pad columns must be -1e30."""
    v = r["rc"].vocab_size
    a = np.asarray(a.float() if torch.is_tensor(a) else a, np.float32)
    assert a.shape[-1] == padded_vocab(r["pc"])
    if a.shape[-1] > v:
        np.testing.assert_allclose(a[..., v:], -1e30, rtol=1e-3)
    return a[..., :v]


@pytest.mark.parametrize("name", NAMES)
def test_lm_forward_matches_reference(runs, name):
    r = runs(name)
    with torch.no_grad():
        ours, aux = r["model"]({"tokens": _t(r["toks"]).long()})
    assert ours.dtype == getattr(torch, r["pc"].compute_dtype)
    assert float(aux) == 0.0
    _close(_vocab(r, ours), _vocab(r, r["forward"]), r["tol"], name)


@pytest.mark.parametrize("name", NAMES)
def test_lm_prefill_matches_reference(runs, name):
    r = runs(name)
    lg, cache = r["model"].prefill({"tokens": _t(r["toks"][:, :S]).long()},
                                   S + NEW)
    assert lg.dtype == torch.float32 and lg.shape[:2] == (B, 1)
    _close(_vocab(r, lg), _vocab(r, r["prefill"]), r["tol"], name)
    want = cache_from_reference(r["cache"], device="cpu")
    assert torch.equal(cache["len"], want["len"])
    assert len(cache["layers"]) == len(want["layers"])
    for i, (a, b) in enumerate(zip(cache["layers"], want["layers"])):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype == torch.bfloat16
            _close(a[k], b[k].float().numpy(), CACHE_TOL, f"{name} {i} {k}")


@pytest.mark.parametrize("name", NAMES)
def test_lm_decode_steps_match_reference(runs, name):
    r = runs(name)
    model = r["model"]
    _, cache = model.prefill({"tokens": _t(r["toks"][:, :S]).long()}, S + NEW)
    for i, want in enumerate(r["steps"]):
        lg, cache = model.decode_step(
            cache, {"tokens": _t(r["toks"][:, S + i:][:, :1]).long()})
        assert lg.dtype == torch.float32
        _close(_vocab(r, lg), _vocab(r, want), r["tol"], f"{name} step {i}")
    assert cache["len"].tolist() == [S + NEW] * B


@pytest.mark.parametrize("name", ["olmo_1b", "fftconv", "hybrid"])
def test_lm_decodes_from_the_reference_prefill_cache(runs, name):
    r = runs(name)
    cache = cache_from_reference(r["cache"], device="cpu")
    assert cache["len"].dtype == torch.int32
    for i, want in enumerate(r["steps"]):
        lg, cache = r["model"].decode_step(
            cache, {"tokens": _t(r["toks"][:, S + i:][:, :1]).long()})
        _close(_vocab(r, lg), _vocab(r, want), r["tol"], f"{name} step {i}")


@pytest.mark.parametrize("name", ["command_r_plus_104b", "fftconv"])
def test_prefill_keeps_the_references_semantics_where_forward_differs(
        runs, name):
    # command-r's prefill ignores parallel_block; an FFT-conv prefill
    # builds its filters over the prompt, forward over the whole sequence:
    # the port's prefill is the reference's, and both differ from forward
    r = runs(name)
    lg, _ = r["model"].prefill({"tokens": _t(r["toks"][:, :S]).long()},
                               S + NEW)
    ref = _vocab(r, r["prefill"])[:, 0]
    fwd = _vocab(r, r["forward"])[:, S - 1]
    tol = r["tol"] * np.abs(ref).max()
    assert np.abs(ref - fwd).max() > 10 * tol
    _close(_vocab(r, lg)[:, 0], ref, r["tol"], name)


def test_to_compute_dtype_is_the_per_use_cast_bit_for_bit(runs):
    r = runs("fftconv_bf16")
    model = lm_from_reference(r["params"], r["pc"], device="cpu")
    toks = {"tokens": _t(r["toks"]).long()}
    with torch.no_grad():
        before, _ = model(toks)
        model.to_compute_dtype()
        after, _ = model(toks)
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    assert dtypes["embed"] == dtypes["layers.1.mix.w_in"] == torch.bfloat16
    assert dtypes["layers.1.mix.filt"] == torch.float32
    assert torch.equal(before, after)
    # every other layer kind in one bfloat16 stack: the weights used in
    # float32 (norms, router, the recurrent mixers' gates, decays, skip
    # and convolution) stay, and the logits do not move
    cfg = dataclasses.replace(
        pconfigs.get_smoke_config("zamba2_7b"), num_experts=4, top_k=2,
        compute_dtype="bfloat16", segments=(
            ("mamba2", 1), ("shared_attn", 1), ("mlstm", 1), ("slstm", 1),
            ("attn_moe", 1)))
    model = LM(cfg, device="cpu")
    with torch.no_grad():
        before, aux_before = model(toks)
        model.to_compute_dtype()
        after, aux_after = model(toks)
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    for name in ("layers.0.ln.scale", "layers.0.mixer.conv_w",
                 "layers.0.mixer.a_log", "layers.0.mixer.dt_bias",
                 "layers.0.mixer.d_skip", "layers.0.mixer.norm",
                 "layers.2.mixer.wi", "layers.2.mixer.wf",
                 "layers.2.mixer.bi", "layers.2.mixer.bf",
                 "layers.2.mixer.norm", "layers.3.mixer.w_gates",
                 "layers.3.mixer.r_gates", "layers.3.mixer.b_gates",
                 "layers.4.moe.router", "shared.ln1.scale"):
        assert dtypes[name] == torch.float32, name
    for name in ("layers.0.mixer.in_proj", "layers.0.mixer.out_proj",
                 "layers.2.mixer.wq", "layers.2.mixer.w_down",
                 "layers.3.mixer.w_out", "layers.4.moe.w_up",
                 "shared.attn.wq", "shared.mlp.w_down"):
        assert dtypes[name] == torch.bfloat16, name
    assert torch.equal(before, after) and torch.equal(aux_before, aux_after)


def test_conversions_raise_on_a_mismatch(runs):
    r = runs("olmo_1b")
    bad = jax.tree_util.tree_map(lambda a: a, r["params"])
    bad["embed"] = bad["embed"][:, :-1]
    with pytest.raises(ValueError, match="embed"):
        lm_from_reference(bad, r["pc"], device="cpu")
    with pytest.raises(ValueError, match="lack"):
        lm_from_reference(r["params"], dataclasses.replace(
            r["pc"], tie_embeddings=False), device="cpu")
    with pytest.raises(ValueError, match="a segment cache with"):
        cache_from_reference({"len": np.zeros(2, np.int32),
                              "segments": [{"ssm": np.zeros((1, 2))}]},
                             device="cpu")
