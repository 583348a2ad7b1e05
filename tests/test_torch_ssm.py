"""The port's recurrent mixers (repro_torch.models.ssm) against the
reference's (repro.models.ssm) on the CPU, at the smoke configs' widths
(zamba2 for Mamba2, xlstm for mLSTM and sLSTM), in float32 and bfloat16.

Inputs and parameters are numpy arrays from a seed; the parameters the
reference initialises to zeros or ones are perturbed so that every one of
them shows. Tolerances as in tests/_lm_parity.py: 1e-4 of max|ref| in
float32, 2e-2 in bfloat16 (outputs and float32 states alike).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as rssm
from repro.models.params import init_tree as rinit_tree
from repro_torch.models import ssm as pssm

from _lm_parity import BF16_TOL, F32_TOL, cfgs, close, t, to_np

RNG = np.random.default_rng(18)
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _gla_inputs(b, l, h, dk, dv):
    q = RNG.standard_normal((b, l, h, dk)).astype(np.float32)
    k = (RNG.standard_normal((b, l, h, dk)) / np.sqrt(dk)).astype(np.float32)
    v = RNG.standard_normal((b, l, h, dv)).astype(np.float32)
    log_a = -RNG.uniform(0.0, 0.3, (b, l, h)).astype(np.float32)
    return q, k, v, log_a


@pytest.mark.parametrize("l,chunk,carried", [
    (200, 128, False),     # 128 does not divide 200: chunks of 100
    (130, 128, True),      # chunks of 65, a state carried in
    (12, 5, False),        # chunks of 4
    (13, 4, True),         # a prime length: chunks of 1
    (64, 128, False),      # one chunk
])
def test_chunked_gla_matches_reference(l, chunk, carried):
    q, k, v, log_a = _gla_inputs(2, l, 3, 8, 5)
    s0 = RNG.standard_normal((2, 3, 8, 5)).astype(np.float32) \
        if carried else None
    y_r, s_r = rssm.chunked_gla(
        *(jnp.asarray(a) for a in (q, k, v, log_a)),
        state=None if s0 is None else jnp.asarray(s0), chunk=chunk)
    y_p, s_p = pssm.chunked_gla(*(t(a) for a in (q, k, v, log_a)),
                                state=None if s0 is None else t(s0),
                                chunk=chunk)
    assert y_p.dtype == s_p.dtype == torch.float32
    close(y_p, y_r, F32_TOL, "y")
    close(s_p, s_r, F32_TOL, "state")


def test_chunked_gla_is_the_token_recurrence():
    # the chunked form against gla_decode_step token by token
    q, k, v, log_a = _gla_inputs(2, 24, 2, 4, 3)
    y, s = pssm.chunked_gla(*(t(a) for a in (q, k, v, log_a)), chunk=8)
    state = torch.zeros((2, 2, 4, 3))
    for i in range(24):
        yi, state = pssm.gla_decode_step(
            t(q[:, i]), t(k[:, i]), t(v[:, i]), torch.exp(t(log_a[:, i])),
            state)
        close(y[:, i], yi.numpy(), F32_TOL, f"token {i}")
    close(s, state.numpy(), F32_TOL)


def test_gla_decode_step_matches_reference():
    q, k, v, _ = _gla_inputs(3, 1, 2, 6, 7)
    a = RNG.uniform(0.5, 1.0, (3, 2)).astype(np.float32)
    s0 = RNG.standard_normal((3, 2, 6, 7)).astype(np.float32)
    y_r, s_r = rssm.gla_decode_step(*(jnp.asarray(x[:, 0]) for x in (q, k, v)),
                                    jnp.asarray(a), jnp.asarray(s0))
    y_p, s_p = pssm.gla_decode_step(*(t(x[:, 0]) for x in (q, k, v)), t(a),
                                    t(s0))
    close(y_p, y_r, F32_TOL)
    close(s_p, s_r, F32_TOL)


@pytest.mark.parametrize("l", [1, 2, 9])
def test_causal_conv_matches_reference(l):
    x = RNG.standard_normal((2, l, 6)).astype(np.float32)
    w = RNG.standard_normal((6, 4)).astype(np.float32)
    y_r, s_r = rssm._causal_conv(jnp.asarray(x), jnp.asarray(w))
    y_p, s_p = pssm._causal_conv(t(x), t(w))
    close(y_p, y_r, F32_TOL)
    assert s_p.shape == (2, 3, 6)
    close(s_p, s_r, F32_TOL)
    # one decode token from that state
    x1 = RNG.standard_normal((2, 1, 6)).astype(np.float32)
    y_r, s_r = rssm._causal_conv(jnp.asarray(x1), jnp.asarray(w), s_r)
    y_p, s_p = pssm._causal_conv(t(x1), t(w), s_p)
    close(y_p, y_r, F32_TOL)
    close(s_p, s_r, F32_TOL)


# -- the three mixers ---------------------------------------------------------

# each mixer and the smoke config whose width it runs at
MIXERS = {"mamba2": "zamba2_7b", "mlstm": "xlstm_1_3b", "slstm": "xlstm_1_3b"}


def _params(kind, rc, seed):
    meta = getattr(rssm, f"{kind}_meta")(rc)
    p = to_np(rinit_tree(meta, jax.random.key(seed)))
    out = {}
    for name, a in p.items():
        if meta[name].init != "normal":         # zeros / ones: perturb
            a = a + 0.3 * RNG.standard_normal(a.shape).astype(np.float32)
        out[name] = a.astype(np.float32)
    return out


def _close_state(kind, ours, theirs, rel, what):
    if kind == "slstm":
        theirs = dict(zip(pssm.SLSTM_STATE, theirs["slstm"]))
    assert set(ours) == set(theirs), (what, sorted(ours), sorted(theirs))
    for name in ours:
        assert ours[name].dtype == torch.float32
        close(ours[name], theirs[name], rel, f"{what} {name}")


def _fwd(kind, pkg, p, cfg, x, **kw):
    fn = getattr(rssm if pkg == "ref" else pssm, f"{kind}_fwd")
    if kind == "slstm":
        kw.pop("chunk", None)
    return fn(p, cfg, x, **kw)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_without_a_state_matches_reference(kind, dtype):
    rc, pc = cfgs(MIXERS[kind])
    p = _params(kind, rc, 1)
    x = RNG.standard_normal((2, 20, rc.d_model)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    y_r, s_r = _fwd(kind, "ref", {k: jnp.asarray(v) for k, v in p.items()},
                    rc, jnp.asarray(x, jd), chunk=8)
    y_p, s_p = _fwd(kind, "port", {k: t(v) for k, v in p.items()}, pc,
                    t(x, td), chunk=8)
    assert s_r is None and s_p is None
    assert y_p.dtype == td
    close(y_p, y_r, _tol(dtype), kind)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_state_handoff_and_decode_match_reference(kind, dtype):
    # the prompt's parallel pass with return_state, then one token from
    # that state, then one token from the initial state
    rc, pc = cfgs(MIXERS[kind])
    p = _params(kind, rc, 2)
    pr = {k: jnp.asarray(v) for k, v in p.items()}
    pp = {k: t(v) for k, v in p.items()}
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    x = RNG.standard_normal((2, 11, rc.d_model)).astype(np.float32)
    y_r, s_r = _fwd(kind, "ref", pr, rc, jnp.asarray(x, jd), chunk=4,
                    return_state=True)
    y_p, s_p = _fwd(kind, "port", pp, pc, t(x, td), chunk=4,
                    return_state=True)
    close(y_p, y_r, _tol(dtype), f"{kind} prompt")
    _close_state(kind, s_p, s_r, _tol(dtype), f"{kind} handoff")

    x1 = RNG.standard_normal((2, 1, rc.d_model)).astype(np.float32)
    y_r, s_r = _fwd(kind, "ref", pr, rc, jnp.asarray(x1, jd), state=s_r)
    y_p, s_p = _fwd(kind, "port", pp, pc, t(x1, td), state=s_p)
    close(y_p, y_r, _tol(dtype), f"{kind} decode")
    _close_state(kind, s_p, s_r, _tol(dtype), f"{kind} decode state")

    init_r = getattr(rssm, f"{kind}_init_state")(rc, 2)
    init_p = getattr(pssm, f"{kind}_init_state")(pc, 2)
    _close_state(kind, init_p, to_np(init_r), 0.0, f"{kind} init")
    y_r, _ = _fwd(kind, "ref", pr, rc, jnp.asarray(x1, jd), state=init_r)
    y_p, _ = _fwd(kind, "port", pp, pc, t(x1, td), state=init_p)
    close(y_p, y_r, _tol(dtype), f"{kind} first token")


@pytest.mark.parametrize("kind", list(MIXERS))
def test_decode_continues_the_parallel_pass(kind):
    # within the port: a prompt's state handed to decode gives the tokens
    # that the parallel pass over the longer sequence gives
    _, pc = cfgs(MIXERS[kind])
    p = {k: t(v) for k, v in _params(kind, cfgs(MIXERS[kind])[0], 3).items()}
    x = t(RNG.standard_normal((2, 10, pc.d_model)).astype(np.float32))
    whole, _ = _fwd(kind, "port", p, pc, x, chunk=4)
    _, state = _fwd(kind, "port", p, pc, x[:, :7], chunk=4,
                    return_state=True)
    for i in range(7, 10):
        y, state = _fwd(kind, "port", p, pc, x[:, i:i + 1], state=state)
        close(y[:, 0], whole[:, i], F32_TOL, f"{kind} token {i}")


def test_meta_and_dims_are_the_references():
    for kind, arch in MIXERS.items():
        rc, pc = cfgs(arch)
        theirs = getattr(rssm, f"{kind}_meta")(rc)
        ours = getattr(pssm, f"{kind}_meta")(pc)
        assert list(ours) == list(theirs)
        for name, m in ours.items():
            assert (m.shape, m.init, m.scale) == (
                theirs[name].shape, theirs[name].init, theirs[name].scale)
    assert pssm.mamba2_dims(cfgs("zamba2_7b")[1]) == rssm.mamba2_dims(
        cfgs("zamba2_7b")[0])
