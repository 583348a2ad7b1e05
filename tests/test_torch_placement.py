"""What a rank holds on a mesh, against the reference's layout, with no
ranks: the dim FSDP2 cuts (``runtime.trainer.fsdp_dims``, by
``parallel.rules.fsdp_dim``) against the dim of the reference's sanitized
spec that carries the data axes, the dry run's argument bytes against the
reference layout's, and the dry run's ``temp_bytes``.

The reference's specs come from ``repro.parallel.rules`` (``make_rules``,
``sanitize_spec``) on ``jax.sharding.AbstractMesh`` shapes, the port's on
``{axis: size}`` mappings of the same shapes. The dry-run cells are built
as rank 0 of a fake 256-rank group on the ``meta`` device.
"""

import math

import pytest
from jax.sharding import AbstractMesh

from repro.models import lm as rlm
from repro.models.params import pspec_tree as rpspec_tree
from repro.parallel import rules as rrules
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_cell
from repro_torch.models import lm as plm
from repro_torch.parallel import fsdp_dim, make_rules
from repro_torch.runtime.trainer import fsdp_dims
from test_torch_rules import _by_name, _configs

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
PROFILES = [("train", False), ("serve", False), ("train", True)]


def _reference_specs(rc, jm, rules):
    """{port's parameter name: (shape, the reference's sanitized spec),
    a stacked layer's without its leading layer dim}."""
    rmeta = rlm.model_meta(rc)
    metas = _by_name(rmeta, rc, lambda m, stacked: (m, stacked))
    specs = _by_name(rpspec_tree(rmeta, rules), rc, lambda s, stacked: s)
    out = {}
    for name, (m, stacked) in metas.items():
        spec = tuple(rrules.sanitize_spec(specs[name], m.shape, jm))
        assert not stacked or spec[0] is None
        out[name] = (m.shape[1:], spec[1:]) if stacked else (m.shape, spec)
    return out


def _reference_dims(rc, jm, rules):
    """{port's parameter name: the dim of the reference's sanitized spec
    that carries ``rules["dp"]``, else 0}."""
    return {name: next((i for i, ax in enumerate(spec)
                        if ax is not None and ax == rules.get("dp")), 0)
            for name, (_, spec) in _reference_specs(rc, jm, rules).items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCH_IDS))
def test_fsdp_dims_are_the_references_data_dims(arch, mesh):
    shape, names = MESHES[mesh]
    jm, pm = AbstractMesh(shape, names), dict(zip(names, shape))
    rc, pc = _configs(arch, False)
    pmeta = plm.model_meta(pc)
    for profile, pods in PROFILES:
        rules = make_rules(pm, pipeline_pods=pods, profile=profile)
        got = fsdp_dims(pm, pmeta, rules)
        assert got == _reference_dims(rc, jm, rules), (profile, pods)
    # the MoE's experts are cut along moe_d, not along the expert axis
    if pc.num_experts:
        train = fsdp_dims(pm, pmeta, make_rules(pm))
        assert train["layers.0.moe.w_up"] == 1
        assert train["layers.0.moe.w_down"] == 2


def test_fsdp_dim_reads_the_data_axes_of_a_spec():
    assert fsdp_dim(("model", "data"), "data") == 1
    assert fsdp_dim(("model", None, ("pod", "data")), ("pod", "data")) == 2
    assert fsdp_dim((None,), "data") == 0
    assert fsdp_dim(("data", None), ("pod", "data")) == 0   # dropped
    assert fsdp_dim((), "data") == 0


def _reference_layout_bytes(rc, jm, rules) -> int:
    """Rank 0's float32 parameters, gradients and two moments in the
    reference's layout: each parameter cut by every axis of its sanitized
    spec."""
    total = 0
    for shape, spec in _reference_specs(rc, jm, rules).values():
        parts = math.prod(jm.shape[a] for ax in spec if ax is not None
                          for a in (ax if isinstance(ax, tuple) else (ax,)))
        total += math.prod(shape) // parts * 4 * 4
    return total


def test_dbrx_train_argument_bytes_are_the_reference_layouts():
    rc, _ = _configs("dbrx_132b", False)
    jm = AbstractMesh((16, 16), ("data", "model"))
    want = _reference_layout_bytes(rc, jm, rrules.make_rules(jm))
    with dryrun._fake_group(256):
        mesh = make_production_mesh(multi_pod=False)
        cell = build_cell("dbrx-132b", "train_4k", mesh)
        model, dims = dryrun.placed_lm(mesh, cell)
        got = dryrun._argument_bytes(cell, model, None, model.dp_size, dims)
        # FSDP2's first dim alone would leave the expert blocks (1, d, ff)
        # whole on data rank 0
        dim0 = dryrun._argument_bytes(cell, model, None, model.dp_size,
                                      dict.fromkeys(dims, 0))
    assert got <= 1.01 * want, (got, want)
    assert 8e9 < got < 1e10 and dim0 > 1e11, (got, dim0)


def test_a_train_cells_temp_bytes_are_counted_and_vocab_lean():
    rec = dryrun.run_cell("olmo-1b", "train_4k", False)
    assert rec["status"] == "ok"            # a dense cell: seconds to trace
    mem = rec["memory"]
    assert mem["output_bytes"] is None and mem["alias_bytes"] is None
    cfg = get_config("olmo-1b")
    rows = 256 // 16
    whole_logits = rows * 4096 * plm.padded_vocab(cfg) * 4   # float32
    assert 0 < mem["temp_bytes"] <= whole_logits, (mem, whole_logits)
