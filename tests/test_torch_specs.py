"""``repro_torch.launch.specs`` against ``repro.launch.specs``.

Both packages' ``make_rules`` and ``cache_pspecs`` read only a mesh's
``axis_names`` and its ``shape`` mapping, so both are handed the same
stand-in mesh (``Mesh``) and no device is needed. The port's cache is one
entry per layer, so its specs must be the reference's per-segment specs
with their stacked axis dropped, repeated for each layer of the segment
(sLSTM's four-tuple under the port's names). Cases: the (4, 2) and (2, 2)
meshes, a batch over the data ranks and one smaller than them (the
flash-decoding layout), and every smoke config of the reference's own
check (``tests/_dist_worker.py``'s ``check_dryrun_cell_tiny``) plus
olmo-1b and an FFT-conv LM.

The serve profile's FSDP decision: the reference's ``build_cell`` on a
(1, 1) JAX mesh of the one CPU device (Auto axes) with
``REPRO_SERVE_WEIGHT_STATIONARY=1`` keeps ``fsdp`` in its parameters'
specs exactly where the port's ``build_cell`` keeps it in its rules, at
the reference's budget of 8e9 bytes passed explicitly.
"""

import dataclasses
import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import specs
from repro_torch.models.config import SHAPES_BY_NAME
from repro_torch.parallel import make_rules

ARCHS = ("granite_8b", "zamba2_7b", "xlstm_1_3b", "phi35_moe_42b", "olmo_1b",
         "fftconv")
MESHES = ((4, 2), (2, 2))
BATCHES = (8, 1)
REFERENCE_BUDGET = 8e9      # bytes: the reference's, half a TPU's 16 GB


class Mesh:
    """What the rules read of a mesh: its axis names and their sizes."""

    def __init__(self, data, model):
        self.axis_names = ("data", "model")
        self.shape = {"data": data, "model": model}


def _cfgs(arch, full=False):
    """(the reference's config, the port's): smoke unless ``full``;
    ``fftconv`` is olmo-1b with every layer an FFT-conv layer."""
    from repro import configs as rconfigs
    from repro_torch import configs as pconfigs
    name = "olmo_1b" if arch == "fftconv" else arch
    get = ("get_config" if full else "get_smoke_config")
    out = (getattr(rconfigs, get)(name), getattr(pconfigs, get)(name))
    if arch == "fftconv":
        out = tuple(dataclasses.replace(
            c, segments=(("fftconv_mlp", c.num_layers),)) for c in out)
    return out


def _per_layer(ref, rc):
    """The reference's cache specs as the port lays its cache out."""
    layers = []
    for seg, (kind, count) in zip(ref["segments"], rc.resolved_segments()):
        if kind == "slstm":
            entry = {k: tuple(leaf)[1:]
                     for k, leaf in zip("cnhm", seg["slstm"])}
        else:
            entry = {k: tuple(spec)[1:] for k, spec in seg.items()}
        layers += [entry] * count
    return {"len": tuple(ref["len"]), "layers": layers}


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("dm", MESHES, ids=lambda dm: f"{dm[0]}x{dm[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_are_the_references_per_layer(arch, dm, batch):
    from repro.launch.specs import cache_pspecs
    from repro.parallel import make_rules as rmake_rules
    rc, pc = _cfgs(arch)
    mesh = Mesh(*dm)
    rules = make_rules(mesh)
    assert rules == rmake_rules(mesh)
    want = _per_layer(cache_pspecs(rc, batch, mesh, rmake_rules(mesh)), rc)
    assert specs.cache_pspecs(pc, batch, mesh, rules) == want


@pytest.mark.parametrize("shape", list(SHAPES_BY_NAME))
@pytest.mark.parametrize("arch", ("olmo_1b", "qwen2_vl_7b", "musicgen_large"))
def test_batch_abstract_is_the_references(arch, shape):
    from repro.launch.specs import batch_abstract
    from repro.models.config import SHAPES_BY_NAME as RSHAPES
    rc, pc = _cfgs(arch)
    want = {k: (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in batch_abstract(rc, RSHAPES[shape]).items()}
    got = specs.batch_abstract(pc, SHAPES_BY_NAME[shape])
    assert all(t.device.type == "meta" for t in got.values())
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
            for k, v in got.items()} == want


@pytest.mark.parametrize("arch", ("olmo_1b", "granite_8b", "xlstm_1_3b",
                                  "phi35_moe_42b", "fftconv"))
def test_serve_profile_drops_fsdp_where_the_reference_does(arch, monkeypatch):
    import jax
    from repro.launch.specs import build_cell as rbuild_cell
    monkeypatch.setenv("REPRO_SERVE_WEIGHT_STATIONARY", "1")
    rc, pc = _cfgs(arch, full=True)
    rmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    import repro.launch.specs as rspecs
    monkeypatch.setattr(rspecs, "get_config", lambda name: rc)
    ref = rbuild_cell(arch, "decode_32k", rmesh)
    ref_fsdp = "data" in tuple(ref.in_shardings[0]["embed"].spec)
    cell = specs.build_cell(pc, "decode_32k", Mesh(1, 1),
                            serve_budget=REFERENCE_BUDGET)
    assert ("fsdp" in cell.rules) == ref_fsdp
    assert cell.arch.param_dtype == "bfloat16"
    assert cell.arch.reduce_dtype == "bfloat16"
    # the budget is what decides: at 4-way tensor parallelism phi3.5-moe's
    # 83.7 GB of bf16 weights fit half an 80 GB card, not 8e9 bytes
    if arch == "phi35_moe_42b":
        four = Mesh(1, 4)
        assert "fsdp" in specs.build_cell(
            pc, "decode_32k", four, serve_budget=REFERENCE_BUDGET).rules
        assert "fsdp" not in specs.build_cell(
            pc, "decode_32k", four, serve_budget=40e9).rules


@pytest.fixture(scope="module")
def one_rank():
    """A gloo world of this one process and a (1, 1) (data, model) mesh."""
    from repro_torch.core import comm
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield comm.make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


def test_build_cell_on_one_rank_gives_the_three_steps(one_rank,
                                                      monkeypatch):
    from repro_torch.models import LM
    from repro_torch.models.config import ShapeConfig
    monkeypatch.delenv("REPRO_SERVE_WEIGHT_STATIONARY", raising=False)
    _, pc = _cfgs("olmo_1b")
    kinds = {}
    for kind in ("train", "prefill", "decode"):
        cell = specs.build_cell(pc, ShapeConfig("t", 8, 2, kind), one_rank)
        kinds[kind] = cell.kind
        model = cell.place(LM(pc, device="cpu"))
        toks = torch.arange(16).reshape(2, 8) % pc.vocab_size
        if kind == "train":
            from repro_torch.optim import adamw_init
            opt = adamw_init(dict(model.named_parameters()))
            _, _, metrics = cell.fn(model, opt, {"tokens": toks,
                                                 "labels": toks})
            assert torch.isfinite(metrics["loss"])
        elif kind == "prefill":
            assert cell.fn(model, {"tokens": toks}).shape[:2] == (2, 1)
        else:
            cache = model.init_cache(2, 8)
            logits, cache = cell.fn(model, cache, {"tokens": toks[:, :1]})
            assert logits.shape[:2] == (2, 1)
            assert cache["len"].tolist() == [1, 1]
    assert kinds == {"train": "train", "prefill": "prefill",
                     "decode": "decode"}
    skip = specs.build_cell("olmo_1b", "long_500k", one_rank)
    assert skip.kind == "skip" and "quadratic" in skip.skip_reason
    assert specs.build_cell("xlstm_1_3b", "long_500k",
                            one_rank).kind == "decode"
    # no pod axis on this mesh: pipeline=True keeps the plain train cell
    plain = specs.build_cell("olmo_1b", "train_4k", one_rank, pipeline=True)
    assert plain.kind == "train" and not plain.pipelined


def test_cell_build_draws_the_constructors_weights_placed(one_rank):
    """On the one-rank mesh ``Cell.build`` (a meta LM placed, then drawn a
    parameter at a time) holds exactly ``LM(cfg, generator=...)``'s
    weights, FFT-conv and MoE layers included."""
    from repro_torch.models import LM
    from repro_torch.models.config import ShapeConfig
    _, pc = _cfgs("phi35_moe_42b")
    pc = dataclasses.replace(pc, segments=(("fftconv_mlp", 1),
                                           ("attn_moe", 1)), num_layers=2)
    cell = specs.build_cell(pc, ShapeConfig("t", 8, 2, "decode"), one_rank)
    got = dict(cell.build(torch.Generator().manual_seed(4))
               .named_parameters())
    want = LM(pc, device="cpu", generator=torch.Generator().manual_seed(4))
    for name, p in want.named_parameters():
        assert torch.equal(got[name], p), name


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_fsdp_skips_a_frozen_lm_on_one_data_rank(one_rank, monkeypatch,
                                                 kind):
    """On the (1, 1) mesh a train cell's LM goes under FSDP2 (each
    parameter a DTensor, its gradient summed over the data ranks), while
    a prefill or decode cell's frozen LM has nothing to shard and stays
    plain."""
    from torch.distributed.fsdp import FSDPModule
    from repro_torch.models import LM
    from repro_torch.models.config import ShapeConfig
    monkeypatch.delenv("REPRO_SERVE_WEIGHT_STATIONARY", raising=False)
    _, pc = _cfgs("olmo_1b")
    cell = specs.build_cell(pc, ShapeConfig("t", 8, 2, kind), one_rank)
    assert "fsdp" in cell.rules
    model = cell.place(LM(pc, device="cpu"))
    sharded = kind == "train"
    assert isinstance(model, FSDPModule) == sharded
    assert all(hasattr(p, "device_mesh") == sharded
               for p in model.parameters())
