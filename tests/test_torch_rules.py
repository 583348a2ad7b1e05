"""The port's sharding rules and metadata (repro_torch.parallel.rules,
models.params, optim.opt_meta, data.batch_specs) against the reference's
(repro.parallel.rules) with no ranks: the reference on
``jax.sharding.AbstractMesh`` shapes, the port on ``{axis: size}``
mappings of the same shapes.

Every config of both packages, smoke and full size (metadata only, nothing
allocated), on the meshes (2, 2), (4, 2), (2, 2, 2), (16, 16) and
(2, 16, 16), under both profiles and with ``pipeline_pods``: the rule
tables, the logical axes leaf by leaf, the raw and the sanitized specs.
The reference stacks each segment's layers on a leading axis (logical
None); the port's layer ``i`` holds the slice of that stack, so its
logical axes and specs are the reference's without the first entry.
"""

import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as rconfigs
from repro.data import batch_specs as rbatch_specs
from repro.models import lm as rlm
from repro.models.config import ShapeConfig as RShape
from repro.models.params import abstract_tree as rabstract_tree
from repro.models.params import is_meta as ris_meta
from repro.models.params import pspec_tree as rpspec_tree
from repro.optim import opt_meta as ropt_meta
from repro.parallel import rules as rrules
from repro_torch import configs as pconfigs
from repro_torch.data import batch_specs
from repro_torch.models import lm as plm
from repro_torch.models.config import ShapeConfig
from repro_torch.models.params import (ParamMeta, abstract_tree, is_meta,
                                       param_count, pspec_tree)
from repro_torch.optim import opt_meta
from repro_torch.parallel import (NamedSharding, logical_shardings,
                                  make_rules, sanitize_spec,
                                  sanitized_shardings)

MESHES = {
    "2x2": ((2, 2), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
PROFILES = [("train", False), ("serve", False), ("train", True)]
ARCHS = list(pconfigs.ARCH_IDS)


def _meshes(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names), dict(zip(names, shape))


def _configs(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    return getattr(rconfigs, get)(arch), getattr(pconfigs, get)(arch)


def _spec(p):
    return tuple(p)


def _by_name(tree, cfg, leaf):
    """A reference tree shaped as ``model_meta`` by the port's parameter
    names, each stacked leaf unstacked by ``leaf(x, stacked)``."""
    out = {"embed": leaf(tree["embed"], False)}
    if "lm_head" in tree:
        out["lm_head"] = leaf(tree["lm_head"], False)
    for name, x in tree["final_norm"].items():
        out[f"final_norm.{name}"] = leaf(x, False)
    for part, sub in tree.get("shared", {}).items():
        for name, x in sub.items():
            out[f"shared.{part}.{name}"] = leaf(x, False)
    i = 0
    for seg, (_, count) in zip(tree["segments"], cfg.resolved_segments()):
        for j in range(count):
            for part, sub in seg.get("layers", {}).items():
                for name, x in sub.items():
                    out[f"layers.{i + j}.{part}.{name}"] = leaf(x, True)
        i += count
    return out


def _flat(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("profile,pods", PROFILES)
def test_rule_tables_equal_the_references(mesh, profile, pods):
    jm, pm = _meshes(mesh)
    assert make_rules(pm, pipeline_pods=pods, profile=profile) == \
        rrules.make_rules(jm, pipeline_pods=pods, profile=profile)
    assert make_rules({"fft": 8}) == rrules.make_rules(
        AbstractMesh((8,), ("fft",))) == {}


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logical_axes_and_counts_equal_the_references(arch, smoke):
    rc, pc = _configs(arch, smoke)
    ref = _by_name(rlm.model_meta(rc), rc,
                   lambda m, s: (m.shape[1:] if s else m.shape,
                                 m.logical[1:] if s else m.logical, m.init,
                                 m.scale))
    ours = {k: (m.shape, m.logical, m.init, m.scale)
            for k, m in _flat(plm.model_meta(pc)).items()}
    assert ours == ref
    assert param_count(plm.model_meta(pc)) == sum(
        int(np.prod(m.shape)) for m in jax.tree_util.tree_leaves(
            rlm.model_meta(rc), is_leaf=ris_meta))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_shardings_equal_the_references(arch, mesh):
    jm, pm = _meshes(mesh)
    for smoke, (profile, pods) in itertools.product((True, False), PROFILES):
        rc, pc = _configs(arch, smoke)
        rules = make_rules(pm, pipeline_pods=pods, profile=profile)
        rmeta, pmeta = rlm.model_meta(rc), plm.model_meta(pc)

        def unstack(p, stacked):
            p = _spec(p)
            assert not stacked or p[0] is None
            return p[1:] if stacked else p
        want = _by_name(rpspec_tree(rmeta, rules), rc, unstack)
        assert _flat(pspec_tree(pmeta, rules)) == want
        got = _flat(logical_shardings(pm, pmeta, rules))
        want = _by_name(rrules.logical_shardings(jm, rmeta, rules), rc,
                        lambda s, stacked: unstack(s.spec, stacked))
        assert {k: v.spec for k, v in got.items()} == want, (arch, smoke)
        assert all(isinstance(v, NamedSharding) and v.mesh is pm
                   for v in got.values())
        # the optimizer state's metadata mirrors the parameters'
        om, rom = opt_meta(pmeta), ropt_meta(rmeta)
        assert om["step"].shape == () and om["step"].dtype == torch.int32
        assert {k: (m.shape, m.logical, m.dtype, m.init) for k, m in
                _flat(om["mu"]).items()} == {
            k: (m.shape, m.logical, torch.float32, "zeros")
            for k, m in _flat(pmeta).items()}
        assert _flat(pspec_tree(om["nu"], rules)) == _by_name(
            rpspec_tree(rom["nu"], rules), rc, unstack)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sanitize_drops_the_axes_that_do_not_divide(mesh):
    jm, pm = _meshes(mesh)
    axes = list(pm) + [None, tuple(pm)[:2] if len(pm) > 1 else None]
    for spec in itertools.product(axes, repeat=2):
        if len({a for a in spec if isinstance(a, str)}) < sum(
                isinstance(a, str) for a in spec):
            continue
        for shape in ((1, 3), (2, 4), (16, 6), (32, 512), (6, 0)):
            want = tuple(rrules.sanitize_spec(jax.sharding.PartitionSpec(
                *spec), shape, jm))
            assert sanitize_spec(spec, shape, pm) == want, (spec, shape)


def test_abstract_tree_allocates_nothing_and_sanitized_shardings_agree():
    rc, pc = _configs("command_r_plus_104b", False)
    jm, pm = _meshes("16x16")
    tree = abstract_tree(plm.model_meta(pc))
    leaves = _flat(tree)
    assert all(t.device.type == "meta" for t in leaves.values())
    assert sum(t.numel() for t in leaves.values()) > 1e11
    rules = make_rules(pm)
    got = _flat(sanitized_shardings(pm, tree,
                                    pspec_tree(plm.model_meta(pc), rules)))
    rmeta = rlm.model_meta(rc)
    want = rrules.sanitized_shardings(jm, rabstract_tree(rmeta),
                                      rpspec_tree(rmeta, rules))
    want = _by_name(want, rc, lambda s, st: _spec(s.spec)[1:] if st
                    else _spec(s.spec))
    assert {k: v.spec for k, v in got.items()} == want


@pytest.mark.parametrize("arch", ["olmo_1b", "qwen2_vl_7b",
                                  "musicgen_large"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_batch_specs_equal_the_references(arch, kind):
    rc, pc = _configs(arch, True)
    for mesh in MESHES:
        jm, pm = _meshes(mesh)
        rules = make_rules(pm)
        want = rbatch_specs(rc, RShape("s", 16, 4, kind), rules)
        got = batch_specs(pc, ShapeConfig("s", 16, 4, kind), rules)
        assert got == {k: _spec(v) for k, v in want.items()}


def test_param_meta_needs_an_axis_per_dim():
    with pytest.raises(ValueError, match="differ in length"):
        ParamMeta((2, 3), ("fsdp",))
    assert is_meta(ParamMeta((2,), (None,)))
