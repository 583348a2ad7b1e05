"""The port's MoE block and M-RoPE tables (repro_torch.models.blocks) and
its frontend helpers (repro_torch.models.frontend) against the
reference's (repro.models.blocks, repro.models.frontend) on the CPU, at
the smoke configs' widths.

Inputs and parameters are numpy arrays from a seed. Tolerances as in
tests/_lm_parity.py: 1e-4 of max|ref| in float32, 2e-2 in bfloat16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import blocks as rb
from repro.models import frontend as rfrontend
from repro.models.params import init_tree as rinit_tree
from repro_torch import configs as pconfigs
from repro_torch.models import blocks as pb, mrope_positions, synth_embeddings

from _lm_parity import BF16_TOL, F32_TOL, cfgs, close, t, to_np

RNG = np.random.default_rng(20)


# -- MoE ----------------------------------------------------------------------


def _moe_params(rc, seed, router_scale=1.0):
    p = to_np(rinit_tree(rb.moe_meta(rc), jax.random.key(seed)))
    p["router"] = p["router"] * router_scale
    return p


@pytest.mark.parametrize("arch,changes,groups", [
    ("phi35_moe_42b", {}, 1),
    ("phi35_moe_42b", dict(capacity_factor=0.1), 1),    # forces drops
    ("phi35_moe_42b", {}, 3),                           # 3 groups -> 2
    ("dbrx_132b", dict(top_k=3), 2),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_matches_reference(arch, changes, groups, dtype):
    rc, pc = cfgs(arch, **changes)
    # a router 200x the init's scale, so that the top-k is not a near tie
    p = _moe_params(rc, 7, 200.0)
    x = RNG.standard_normal((2, 10, rc.d_model)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    out_r, aux_r = rb.moe_fwd({k: jnp.asarray(v) for k, v in p.items()}, rc,
                              jnp.asarray(x, jd), groups)
    pt = {k: t(v) for k, v in p.items()}
    out_p, aux_p = pb.moe_fwd(pt, pc, t(x, td), groups)
    assert out_p.dtype == td and aux_p.dtype == torch.float32
    close(out_p, out_r, F32_TOL if dtype == "float32" else BF16_TOL)
    close(aux_p, aux_r, F32_TOL)
    g = 1 if groups == 1 else 2             # the groups shrink to divide 20
    _, _, topi, _, kept = pb.moe_route(pt, pc, t(x, td).reshape(g, 20 // g,
                                                                -1))
    topi, kept = topi.reshape(20, -1), kept.reshape(20, -1)
    assert topi.shape == kept.shape == (20, pc.top_k)
    cap = pb.moe_capacity(pc, 20 // g)
    # no expert holds more than its capacity in any group
    for rows in torch.arange(20).chunk(g):
        held = torch.bincount(topi[rows][kept[rows]],
                              minlength=pc.num_experts)
        assert int(held.max()) <= cap
    if changes.get("capacity_factor") == 0.1:
        assert cap == 4 and int((~kept).sum()) > 0


def test_moe_ties_go_to_the_lower_index():
    # a zero router: every gate 1/E, so lax.top_k takes experts 0..k-1
    rc, pc = cfgs("phi35_moe_42b", capacity_factor=4.0)
    p = _moe_params(rc, 8, 0.0)
    x = RNG.standard_normal((1, 6, rc.d_model)).astype(np.float32)
    out_r, _ = rb.moe_fwd({k: jnp.asarray(v) for k, v in p.items()}, rc,
                          jnp.asarray(x))
    pt = {k: t(v) for k, v in p.items()}
    out_p, _ = pb.moe_fwd(pt, pc, t(x))
    _, _, topi, _, kept = pb.moe_route(pt, pc, t(x))
    assert topi.tolist() == [[[0, 1]] * 6] and bool(kept.all())
    close(out_p, out_r, F32_TOL)


@pytest.mark.parametrize("tokens,want", [(1, 4), (4, 4), (2048, 320),
                                         (2064, 322), (3, 4)])
def test_moe_capacity_is_the_references(tokens, want):
    # phi3.5-moe's: 16 experts, top-2, capacity factor 1.25
    cfg = pconfigs.get_config("phi35_moe_42b")
    assert pb.moe_capacity(cfg, tokens) == min(want, 2 * tokens)


# -- M-RoPE and the frontend helpers -----------------------------------------


@pytest.mark.parametrize("batch,seq,grid", [(2, 300, 16), (1, 100, 16),
                                            (3, 20, 2)])
def test_mrope_positions_are_the_references(batch, seq, grid):
    ours = mrope_positions(batch, seq, grid, device="cpu")
    theirs = np.asarray(rfrontend.mrope_positions(batch, seq, grid))
    assert ours.dtype == torch.int32 and ours.shape == (3, batch, seq)
    assert np.array_equal(ours.numpy(), theirs)


def test_mrope_tables_match_reference():
    rc, pc = cfgs("qwen2_vl_7b")
    pos3 = np.asarray(rfrontend.mrope_positions(2, 20, 3))
    cos_r, sin_r = rb.rope_tables(rc, jnp.asarray(pos3))
    cos_p, sin_p = pb.rope_tables(pc, t(pos3))
    assert cos_p.shape == (2, 20, pc.hd // 2)
    close(cos_p, cos_r, F32_TOL)
    close(sin_p, sin_r, F32_TOL)
    # text-only (B, S) positions drive all three streams: the plain RoPE
    text = (np.arange(9)[None] + np.array([[0], [30]])).astype(np.int32)
    cos_r, sin_r = rb.rope_tables(rc, jnp.asarray(text))
    cos_p, sin_p = pb.rope_tables(pc, t(text))
    close(cos_p, cos_r, F32_TOL)
    close(sin_p, sin_r, F32_TOL)
    plain = pb._rope_angles(t(text), pc.hd)
    assert torch.equal(cos_p, plain[0]) and torch.equal(sin_p, plain[1])
    with pytest.raises(ValueError, match="sections"):
        pb.rope_tables(dataclasses.replace(pc, mrope_sections=(3, 2, 1)),
                       t(text))


def test_synth_embeddings_follow_the_reference_rule():
    _, pc = cfgs("musicgen_large", compute_dtype="bfloat16")
    e = synth_embeddings(pc, 3, 50, torch.Generator().manual_seed(4),
                         device="cpu")
    again = synth_embeddings(pc, 3, 50, torch.Generator().manual_seed(4),
                             device="cpu")
    assert e.shape == (3, 50, pc.d_model) and e.dtype == torch.bfloat16
    assert torch.equal(e, again)
    assert abs(float(e.float().std()) / 0.02 - 1) < 0.05
    theirs = rfrontend.synth_embeddings(rconfigs.get_smoke_config(
        "musicgen_large"), 3, 50, jax.random.key(4))
    assert theirs.shape == tuple(e.shape)
