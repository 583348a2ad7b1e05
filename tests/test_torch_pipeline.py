"""``repro_torch.parallel.pipeline``/``pipelined_lm`` and
``repro_torch.launch.dryrun`` against the reference's, with no ranks
spawned: which configs the pipeline takes, the microbatch rule, the stage
cut against ``pipeline_param_shardings``'s specs on a stand-in mesh (a
JAX ``AbstractMesh`` and the port's ``{axis: size}`` mapping), a stage's
LM drawn as the whole LM's layers, ``model_flops`` and
``inner_scan_flops_correction`` for every arch and shape, the dry run's
bucketing against ``parse_collectives``, ``build_cell(..., pipeline=True)``
on one gloo rank against the plain cell, and the dry-run CLI in a
subprocess (so that its fake process group never enters this process):
granite-8b ``train_4k`` on the (16, 16) mesh and a full-attention arch at
``long_500k`` (a skip). ``tests/test_torch_dryrun_pipeline.py`` runs the
pipelined cell on (2, 16, 16); ``tests/test_torch_mesh_pipeline.py`` the
pipeline on 4 gloo ranks.
"""

import dataclasses
import datetime
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS
from repro_torch.launch import dryrun
from repro_torch.models.config import SHAPES
from repro_torch.parallel import pipelined_lm

ROOT = Path(__file__).resolve().parents[1]
DRYRUN_TIMEOUT = 300        # seconds; a cell takes about 20 s here
STEP_TOL = 1e-5


def reference_dryrun():
    """``repro.launch.dryrun``, imported with this process's XLA_FLAGS left
    as they were (the module sets a 512-device count at import)."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as rdryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return rdryrun


def _cfgs(arch, **changes):
    from repro import configs as rconfigs
    from repro_torch import configs as pconfigs
    return (dataclasses.replace(rconfigs.get_config(arch), **changes),
            dataclasses.replace(pconfigs.get_config(arch), **changes))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_supports_pipeline_is_the_references(arch):
    from repro.parallel.pipelined_lm import supports_pipeline
    rc, pc = _cfgs(arch)
    assert pipelined_lm.supports_pipeline(pc) == supports_pipeline(rc)


def test_the_pipeline_takes_the_six_uniform_attn_mlp_configs():
    from repro_torch.configs import get_config
    assert sorted(a for a in ARCH_IDS if pipelined_lm.supports_pipeline(
        get_config(a))) == sorted(["olmo_1b", "granite_3_2b", "granite_8b",
                                   "command_r_plus_104b", "qwen2_vl_7b",
                                   "musicgen_large"])


def test_microbatches_follow_the_references_rule():
    for bsz in range(1, 41):
        for m in range(1, 13):
            want = m
            while bsz % want:
                want -= 1
            got = pipelined_lm.microbatches(bsz, m)
            assert got == want and bsz % got == 0 and got <= m


@pytest.mark.parametrize("arch,pods", [("granite_8b", 2), ("granite_8b", 4),
                                       ("olmo_1b", 4), ("olmo_1b", 16)])
def test_stage_cut_is_the_references_pod_spec(arch, pods):
    """Each layer's sharding is the reference's stacked spec without its
    leading dim, on the pod rank that holds that layer's row of the
    stacked dim; the rest of the tree is ``logical_shardings``'."""
    from jax.sharding import AbstractMesh
    from repro.models import lm as rlm
    from repro.parallel import make_rules as rmake_rules
    from repro.parallel.pipelined_lm import pipeline_param_shardings as rpps
    from repro_torch.models.lm import model_meta
    from repro_torch.parallel import make_rules
    rc, pc = _cfgs(arch)
    shape = (pods, 16, 16)
    names = ("pod", "data", "model")
    ref = rpps(AbstractMesh(shape, names), rlm.model_meta(rc),
               rmake_rules(AbstractMesh(shape, names), pipeline_pods=True))
    mesh = dict(zip(names, shape))
    ours = pipelined_lm.pipeline_param_shardings(
        mesh, model_meta(pc), make_rules(mesh, pipeline_pods=True))
    layers = rc.num_layers
    for part, leaves in ref["segments"][0]["layers"].items():
        for leaf, sh in leaves.items():
            spec = tuple(sh.spec) + (None,) * 8
            assert spec[0] == "pod"
            for i in range(layers):
                got = ours["layers"][i][part][leaf]
                assert got.stage == i // (layers // pods)
                n = len(got.spec)
                assert got.spec == spec[1:n + 1], (part, leaf)
                first, count = pipelined_lm.stage_layers(layers, pods,
                                                         got.stage)
                assert first <= i < first + count
    for name in ("embed", "final_norm"):
        r, o = ref[name], ours[name]
        if name == "embed":
            assert tuple(r.spec) == o.spec and o.stage is None
        else:
            for k in r:
                assert tuple(r[k].spec) == o[k].spec and o[k].stage is None


def test_a_stack_the_pods_do_not_divide_is_refused():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import model_meta
    from repro_torch.parallel import make_rules
    cfg = dataclasses.replace(get_smoke_config("granite_8b"), num_layers=3)
    mesh = {"pod": 2, "data": 1, "model": 1}
    with pytest.raises(ValueError, match="do not split"):
        pipelined_lm.pipeline_param_shardings(
            mesh, model_meta(cfg), make_rules(mesh, pipeline_pods=True))


def test_a_stage_draws_the_whole_lms_layers():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import LM
    cfg = dataclasses.replace(get_smoke_config("granite_8b"), num_layers=4)
    whole = dict(LM(cfg, device="cpu", generator=torch.Generator()
                    .manual_seed(5)).named_parameters())
    stage = LM(cfg, device="meta").keep_layers(2, 2)
    stage.draw(torch.Generator().manual_seed(5), "cpu")
    got = dict(stage.named_parameters())
    assert sorted(stage.whole_name(n) for n in got) == sorted(
        n for n in whole if not n.startswith(("layers.0.", "layers.1.")))
    for name, p in got.items():
        assert torch.equal(p, whole[stage.whole_name(name)]), name
        assert stage.local_name(stage.whole_name(name)) == name
    assert stage.local_name("layers.0.ln1.scale") is None
    with pytest.raises(ValueError):
        stage.keep_layers(0, 1)


def test_an_embeds_batch_is_refused_clearly():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import LM
    cfg = get_smoke_config("qwen2_vl_7b")
    assert pipelined_lm.supports_pipeline(cfg)
    model = LM(cfg, device="cpu")
    batch = {"embeds": torch.zeros(2, 4, cfg.d_model),
             "labels": torch.zeros(2, 4, dtype=torch.long)}
    with pytest.raises(ValueError, match="batch of tokens"):
        pipelined_lm.pipelined_loss_fn(model, batch, None,
                                       {"dp": "data"})


@pytest.mark.parametrize("shape", [s.name for s in SHAPES])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_scan_correction_are_the_references(arch, shape):
    from repro.models.config import SHAPES_BY_NAME as RSHAPES
    from repro_torch.models.config import SHAPES_BY_NAME
    rdryrun = reference_dryrun()
    rc, pc = _cfgs(arch)
    assert dryrun.model_flops(pc, SHAPES_BY_NAME[shape]) == \
        rdryrun.model_flops(rc, RSHAPES[shape])
    assert dryrun.inner_scan_flops_correction(pc, SHAPES_BY_NAME[shape]) \
        == rdryrun.inner_scan_flops_correction(rc, RSHAPES[shape])


def test_bucketing_is_the_references_parse_collectives():
    """The same collectives as the reference's HLO sample
    (tests/test_dryrun_units.py) give the same operand bytes, counts and
    wire bytes."""
    rdryrun = reference_dryrun()
    hlo = """
ENTRY %main {
  %ag = f32[16,4096]{1,0} all-gather(%p0), replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}
  %ar = bf16[1024]{0} all-reduce(%x), replica_groups=[2,16]<=[32], to_apply=%sum
  %rs = f32[8,128]{1,0} reduce-scatter(%y), replica_groups={{0,1}}, dimensions={0}
  %a2a = f32[64,64]{1,0} all-to-all(%z), replica_groups={{0,1,2,3}}, dimensions={0}
  %cp = f32[32]{0} collective-permute(%w), source_target_pairs={{0,1},{1,0}}
}
"""
    events = [("all-gather", 16 * 4096 * 4, 4), ("all-reduce", 1024 * 2, 16),
              ("reduce-scatter", 8 * 128 * 4, 2),
              ("all-to-all", 64 * 64 * 4, 4),
              ("collective-permute", 32 * 4, 2)]
    assert dryrun.bucket_collectives(events) == rdryrun.parse_collectives(
        hlo, with_wire=True)


@pytest.fixture(scope="module")
def one_rank():
    """A gloo world of this one process and a (1, 1, 1) (pod, data,
    model) mesh."""
    from repro_torch.core import comm
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield comm.make_mesh((1, 1, 1), ("pod", "data", "model"))
    finally:
        dist.destroy_process_group()


def test_a_pipelined_cell_on_one_rank_steps_as_the_plain_cell(one_rank):
    """``build_cell(..., pipeline=True)`` on (1, 1, 1) runs the pipeline
    (one stage, 4 microbatches) and its step equals the plain cell's on
    the same weights: loss, grad_norm and every parameter after it."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.specs import build_cell
    from repro_torch.models import LM
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import local
    cfg = dataclasses.replace(get_smoke_config("olmo_1b"), num_layers=2)
    shape = ShapeConfig("t", 16, 4, "train")
    toks = torch.randint(0, cfg.vocab_size, (4, 16),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": toks}
    out = {}
    for pipeline in (True, False):
        cell = build_cell(cfg, shape, one_rank, pipeline=pipeline)
        assert cell.pipelined == pipeline
        model = cell.place(LM(cfg, device="cpu"))
        opt = adamw_init(dict(model.named_parameters()))
        _, _, metrics = cell.fn(model, opt, batch)
        out[pipeline] = (metrics, {n: local(p).detach().clone()
                                   for n, p in model.named_parameters()})
    (m1, p1), (m0, p0) = out[True], out[False]
    for key in ("loss", "grad_norm"):
        got, want = m1[key].item(), m0[key].item()
        assert abs(got - want) <= STEP_TOL * abs(want), key
    for name, want in p0.items():
        assert (p1[name] - want).abs().max() <= STEP_TOL * want.abs().max()
    with pytest.raises(ValueError, match="pipeline_pods"):
        pipelined_lm.pipelined_loss_fn(LM(cfg, device="cpu"), batch,
                                       one_rank, {"dp": ("pod", "data")})


def run_dryrun(tmp, *args):
    """The dry-run CLI in a subprocess: (exit code, output, {file: record})."""
    out = tmp / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out",
         str(out)], env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=DRYRUN_TIMEOUT)
    recs = {f.stem: json.loads(f.read_text()) for f in out.glob("*.json")}
    return proc.returncode, proc.stdout, recs


FIELDS = ("arch", "shape", "mesh", "chips", "kind", "status", "pipelined",
          "trace_seconds", "memory", "flops_per_device",
          "bytes_per_device_unfused", "collective_bytes_per_device",
          "collective_counts", "collective_wire_bytes_per_device",
          "t_collective_wire", "inner_scan_flops_correction_per_device",
          "t_compute", "t_memory", "t_collective", "bottleneck",
          "model_flops_total", "model_flops_per_device",
          "useful_flops_ratio")


def test_dryrun_of_a_train_cell_on_the_single_pod_mesh(tmp_path):
    from repro.configs import get_config as rget
    from repro.models.config import SHAPES_BY_NAME as RSHAPES
    rc, out, recs = run_dryrun(tmp_path, "--arch", "granite-8b", "--shape",
                               "train_4k", "--mesh", "single")
    assert rc == 0, out
    assert "dry-run: 1 ok, 0 documented skips, 0 errors" in out
    rec = recs["granite-8b_train_4k_single"]
    assert set(FIELDS) <= set(rec)
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["chips"] == 256 and rec["kind"] == "train"
    assert not rec["pipelined"]
    assert rec["model_flops_total"] == reference_dryrun().model_flops(
        rget("granite-8b"), RSHAPES["train_4k"])
    coll = rec["collective_bytes_per_device"]
    assert coll["all-reduce"] > 0           # tensor parallelism
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0   # FSDP
    assert coll["collective-permute"] == 0
    assert rec["flops_per_device"] > rec["model_flops_per_device"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["temp_bytes"] is None


def test_dryrun_skips_full_attention_at_500k(tmp_path):
    rc, out, recs = run_dryrun(tmp_path, "--arch", "granite-8b", "--shape",
                               "long_500k", "--mesh", "both")
    assert rc == 0, out
    assert "dry-run: 0 ok, 2 documented skips, 0 errors" in out
    for mesh in ("single", "multi"):
        rec = recs[f"granite-8b_long_500k_{mesh}"]
        assert rec["status"] == "skip" and "quadratic" in rec["reason"]
