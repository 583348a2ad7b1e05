"""The port's GPipe pipeline over ``pod`` on 4 gloo ranks, against
sequential stages and against the reference's one-device
``jax.value_and_grad`` of ``lm.loss_fn`` and its ``adamw_update`` (the
reference's own pipelined checks sit in its suite that fails on the
installed jax: ROADMAP.md, Queue 3).

The fixture computes the reference's numbers in the pytest process (one
JAX CPU device) and writes them, with its weights by the port's names, to
an ``.npz``; then it runs this file as a script,

    python tests/test_torch_mesh_pipeline.py port IN.npz OUT.npz

which spawns 4 gloo ranks (``torch.multiprocessing``, a FileStore, one
thread each; they never import JAX). On them:

* ``pipeline_forward`` of 4 stages ``tanh(x @ w_s)`` on a (4,) ``pod``
  mesh, 8 microbatches, against the stages applied in turn (numpy), and
  its gradient in every ``w_s`` and in the input against autograd of the
  sequential version (float64, here);
* ``build_cell(..., pipeline=True)``'s train cell of granite-8b smoke
  and olmo-1b smoke (tied embeddings), each on 4 layers, on (4, 1, 1),
  (2, 2, 1) and (2, 1, 2) (pod, data, model): ``pipelined_loss_fn`` with
  ``num_microbatches=4`` and every gradient (summed over ``pod`` where
  whole over it), then one step of the cell (AdamW: the parameters, the
  first moment and grad_norm after it), each gathered whole. Limits:
  ``_lm_parity``'s, the loss within 1e-5 of |ref| and each gradient
  within 1e-4 of its max|ref|; the parameters and first moment after
  the step within 1e-4 of their max, grad_norm within 1e-5. The smoke
  configs compute in float32; granite-8b's loss in bfloat16 compute on
  (2, 2, 1) is held at the reference's 5e-3 of |ref|
  (``tests/_dist_worker.py``'s pipelined check);
* zamba2 smoke (not a uniform ``attn_mlp`` stack) with ``pipeline=True``
  on (2, 2, 1): a plain train cell, its pod ranks replicas, its loss and
  gradients at the same limits;
* FSDP2's all-gathers and reduce-scatters of each pipelined step (a
  layer used M + S - 1 times a step), counted by the dry run's
  ``StepCounter``, equal to ``launch.dryrun.fsdp_collectives``'s count;
* controls that must miss: the pod all-reduce of the whole-over-pod
  gradients skipped (``sync_pod_grads``), and their squares counted on
  every stage in the gradient norm (``pod_norm_groups``).
"""

import dataclasses
import datetime
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytestmark = pytest.mark.slow

ROOT = Path(__file__).resolve().parents[1]
RUN_TIMEOUT = 300       # seconds; the ranks take about 15 s
WORLD = 4
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4          # _lm_parity's LOSS_TOL, F32_TOL
STEP_TOL, NORM_TOL, BF16_LOSS_TOL = 1e-4, 1e-5, 5e-3
BATCH, SEQ, SEED, MICRO = 4, 16, 3, 4
FWD_M, FWD_MB, FWD_D, FWD_TOL = 8, 4, 16, 1e-5

MESHES = ((4, 1, 1), (2, 2, 1), (2, 1, 2))
# model -> (arch, config changes, what the tests hold of the reference:
# its loss, gradients and AdamW step; its loss and gradients; its loss)
MODELS = {"granite": ("granite_8b", {"num_layers": 4}, "step"),
          "olmo": ("olmo_1b", {"num_layers": 4}, "step"),
          "granite_bf16": ("granite_8b", {"num_layers": 4,
                                          "compute_dtype": "bfloat16"},
                           "loss"),
          "zamba2": ("zamba2_7b", {}, "grad")}
# case -> (model, mesh)
CASES = {f"{m}_{'x'.join(map(str, dm))}": (m, dm)
         for m in ("granite", "olmo") for dm in MESHES}
BF16_CASE = ("granite_bf16", (2, 2, 1))
PLAIN_CASE = ("zamba2", (2, 2, 1))


# ---------------------------------------------------------------------------
# the port's run (4 gloo ranks; no JAX)
# ---------------------------------------------------------------------------


def _cfg(model):
    from repro_torch import configs
    arch, changes, _ = MODELS[model]
    return dataclasses.replace(configs.get_smoke_config(arch), **changes)


def _mesh(dm):
    from repro_torch.core.comm import make_mesh
    return make_mesh(dm, ("pod", "data", "model"))


def _forward_case(ref, out):
    """``pipeline_forward`` on (4,) and its gradient: this rank's rows of
    ``out``."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.comm import make_mesh
    from repro_torch.parallel import pipeline_forward
    mesh = make_mesh((WORLD,), ("pod",))
    me = mesh.get_local_rank("pod")
    x = torch.from_numpy(ref["fwd/x"]).requires_grad_()
    w = torch.from_numpy(ref["fwd/w"][me]).requires_grad_()
    y = pipeline_forward(lambda wl, xin: torch.tanh(xin @ wl), w, x, mesh,
                         "pod")
    (y * torch.from_numpy(ref["fwd/g"])).sum().backward()
    grad_x = x.grad.clone()
    dist.all_reduce(grad_x, group=mesh.get_group("pod"))
    parts = [torch.empty_like(w.grad) for _ in range(WORLD)]
    dist.all_gather(parts, w.grad, group=mesh.get_group("pod"))
    out["fwd/y"] = y.detach().numpy()
    out["fwd/grad_x"] = grad_x.numpy()
    out["fwd/grad_w"] = torch.stack(parts).numpy()


def _collect(mesh, tensors):
    """Every rank's ``{name: whole tensor}`` of its stage, merged (the
    ranks at data and model coordinate 0 give theirs)."""
    import torch.distributed as dist
    mine = ({k: v.detach().float().numpy() for k, v in tensors.items()}
            if mesh.get_local_rank("data") == 0
            and mesh.get_local_rank("model") == 0 else {})
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    merged = {}
    for part in every:
        merged.update(part)
    return merged


def _lm_case(model_name, dm, weights, batch):
    """(meta, {kind/name: whole tensor}) of the pipelined (or, for a
    config the pipeline does not take, plain) train cell of
    ``model_name`` on the mesh ``dm``, from ``weights``."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import build_cell
    from repro_torch.models import LM, loss_fn
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import local
    from repro_torch.parallel import pipelined_lm
    cfg = _cfg(model_name)
    mesh = _mesh(dm)
    cell = build_cell(cfg, ShapeConfig("t", SEQ, BATCH, "train"), mesh,
                      pipeline=True)
    whole = LM(cfg, device="cpu")
    with torch.no_grad():
        for name, p in whole.named_parameters():
            p.copy_(torch.from_numpy(weights[name]))
    model = cell.place(whole)
    dp = dm[1]
    d = mesh.get_local_rank("data")
    rows = {k: torch.from_numpy(v[d * BATCH // dp:(d + 1) * BATCH // dp])
            .long() for k, v in batch.items()}
    sh = cell.placed["shardings"]

    def whole_of(tree):
        return {model.whole_name(n): sh[n].gather(local(t).detach())
                for n, t in tree.items()}

    counter = dryrun.StepCounter()
    with_grad = set()
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p: with_grad.add(id(p))) for p in model.parameters()]
    with counter:
        if cell.pipelined:
            loss, _ = pipelined_lm.pipelined_loss_fn(
                model, rows, mesh, cell.rules, num_microbatches=MICRO)
        else:
            loss, _ = loss_fn(model, rows, dp)
        loss.backward()
    for hook in hooks:
        hook.remove()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters()}
    if cell.pipelined:
        pipelined_lm.sync_pod_grads(model, grads, mesh)
    out = {f"grad/{k}": v for k, v in whole_of(grads).items()}
    model.zero_grad(set_to_none=True)
    fsdp = {}
    if cell.pipelined and dp > 1:
        uses = pipelined_lm.microbatches(BATCH // dp, MICRO) + dm[0] - 1
        want = dryrun.fsdp_collectives(model, dp, uses, True, with_grad)
        got = [e for e, op in zip(counter.events, counter.ops)
               if op in ("_allgather_base_", "_reduce_scatter_base_")]
        fsdp = {"got": [[b, n, g] for b, n, g in got],
                "want": [[b, n, g] for b, n, g in want]}

    opt = adamw_init(dict(model.named_parameters()))
    _, opt, metrics = cell.fn(model, opt, rows)
    out.update({f"step/{k}": v for k, v in
                whole_of(dict(model.named_parameters())).items()})
    out.update({f"mu/{k}": v for k, v in whole_of(opt["mu"]).items()})
    meta = dict(loss=float(loss), grad_norm=float(metrics["grad_norm"]),
                step_loss=float(metrics["loss"]), pipelined=cell.pipelined,
                fsdp=fsdp)
    return meta, _collect(mesh, out)


def _port_rank(rank, store_path, in_path, out_path):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.parallel import pipelined_lm
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    ref = np.load(in_path)
    out, meta = {}, {}
    _forward_case(ref, out)

    def weights(model):
        return {k.split("/", 2)[2]: ref[k] for k in ref.files
                if k.startswith(f"{model}/param/")}

    def batch(model):
        return {k: ref[f"{model}/batch/{k}"] for k in ("tokens", "labels")}

    def run(case, model, dm):
        meta[case], arrays = _lm_case(model, dm, weights(model),
                                      batch(model))
        out.update({f"{case}/{k}": v for k, v in arrays.items()})

    for case, (model, dm) in CASES.items():
        run(case, model, dm)
    run("bf16", *BF16_CASE)
    run("plain", *PLAIN_CASE)

    # the controls, on granite (4, 1, 1)
    sync, norm_groups = pipelined_lm.sync_pod_grads, \
        pipelined_lm.pod_norm_groups
    pipelined_lm.sync_pod_grads = lambda model, grads, mesh: None
    try:
        run("control_sync", "granite", (4, 1, 1))
    finally:
        pipelined_lm.sync_pod_grads = sync

    def every_stage(model, groups, mesh):
        pod = mesh.get_group("pod")
        return {n: list(g) + [pod] for n, g in groups.items()}
    pipelined_lm.pod_norm_groups = every_stage
    try:
        run("control_norm", "granite", (4, 1, 1))
    finally:
        pipelined_lm.pod_norm_groups = norm_groups
    if rank == 0:
        np.savez(out_path, meta=json.dumps(meta), **out)
    dist.barrier()
    dist.destroy_process_group()


def port_main(in_path, out_path):
    import torch.multiprocessing as mp
    store = os.path.join(os.path.dirname(os.path.abspath(out_path)),
                         "gloo_store")
    mp.start_processes(_port_rank, args=(store, in_path, out_path),
                       nprocs=WORLD, start_method="spawn")


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _reference(tmp):
    """Per model: the reference's weights, batch, loss, gradients, grad
    norm and one ``adamw_update`` step (parameters, first moment) on one
    device, by the port's names; and the pipeline_forward inputs."""
    import jax
    import jax.numpy as jnp
    from repro.data import SyntheticDataset as RData
    from repro.models import lm as rlm
    from repro.models.config import ShapeConfig as RShape
    from repro.optim import AdamWConfig as ROpt
    from repro.optim import adamw_init as rinit
    from repro.optim import adamw_update as rupdate
    from repro.optim.adamw import global_norm as rnorm
    from repro_torch.convert import flatten_reference
    from _lm_parity import cfgs, to_np
    rng = np.random.default_rng(SEED)
    arrays = {"fwd/x": rng.standard_normal((FWD_M, FWD_MB, FWD_D))
              .astype(np.float32),
              "fwd/w": (rng.standard_normal((WORLD, FWD_D, FWD_D)) * 0.3)
              .astype(np.float32),
              "fwd/g": rng.standard_normal((FWD_M, FWD_MB, FWD_D))
              .astype(np.float32)}
    meta = {}
    update = jax.jit(functools.partial(rupdate, ROpt()))
    for model, (arch, changes, what) in MODELS.items():
        rc, _ = cfgs(arch, **changes)
        batch = RData(rc, RShape("t", SEQ, BATCH, "train"),
                      seed=SEED).batch_at(0)
        params = rlm.init_params(rc, jax.random.key(0))
        x = {k: jnp.asarray(v) for k, v in batch.items()}
        trees = [("param", params)]
        if what == "loss":
            loss = jax.jit(lambda p, b: rlm.loss_fn(p, rc, b)[0])(params, x)
            meta[model] = dict(loss=float(loss))
        else:
            (loss, _), grads = jax.jit(jax.value_and_grad(
                lambda p, b: rlm.loss_fn(p, rc, b), has_aux=True))(params, x)
            meta[model] = dict(loss=float(loss),
                               grad_norm=float(rnorm(grads)))
            trees.append(("grad", grads))
        if what == "step":
            new, state, _ = update(grads, params, rinit(params))
            trees += [("step", new), ("mu", state["mu"])]
        for kind, tree in trees:
            for k, v in flatten_reference(to_np(tree), rc).items():
                arrays[f"{model}/{kind}/{k}"] = np.asarray(v, np.float32)
        for k in ("tokens", "labels"):
            arrays[f"{model}/batch/{k}"] = np.asarray(batch[k])
    np.savez(tmp / "ref.npz", **arrays)
    return arrays, meta


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_pipeline")
    ref, ref_meta = _reference(tmp)
    proc = subprocess.run(
        [sys.executable, __file__, "port", str(tmp / "ref.npz"),
         str(tmp / "port.npz")],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=RUN_TIMEOUT)
    assert proc.returncode == 0, proc.stdout
    z = np.load(tmp / "port.npz")
    ours = {k: z[k] for k in z.files if k != "meta"}
    return ref, ref_meta, ours, json.loads(str(z["meta"]))


def _misses(ours, ref, case, model, kind, tol):
    """The tensors ``kind`` of ``case`` beyond ``tol`` of the max of
    ``model``'s reference."""
    out = []
    prefix = f"{model}/{kind}/"
    for k in ref:
        if k.startswith(prefix):
            name = k[len(prefix):]
            got, want = ours[f"{case}/{kind}/{name}"], ref[k]
            assert got.shape == want.shape, (name, got.shape, want.shape)
            if np.abs(got - want).max() > tol * np.abs(want).max():
                out.append(name)
    return out


def _rel(got, want):
    return abs(got - want) / abs(want)


def test_pipeline_forward_is_the_stages_in_turn_and_so_is_its_gradient(runs):
    import torch
    ref, _, ours, _ = runs
    x = torch.from_numpy(ref["fwd/x"]).double().requires_grad_()
    w = torch.from_numpy(ref["fwd/w"]).double().requires_grad_()
    y = x
    for s in range(WORLD):
        y = torch.tanh(y @ w[s])
    want = np.tanh(ref["fwd/x"] @ ref["fwd/w"][0])
    for s in range(1, WORLD):
        want = np.tanh(want @ ref["fwd/w"][s])
    assert np.abs(ours["fwd/y"] - want).max() <= FWD_TOL
    (y * torch.from_numpy(ref["fwd/g"]).double()).sum().backward()
    for key, grad in (("fwd/grad_x", x.grad), ("fwd/grad_w", w.grad)):
        g = grad.numpy()
        assert np.abs(ours[key] - g).max() <= FWD_TOL * np.abs(g).max(), key


@pytest.mark.parametrize("case", list(CASES))
def test_pipelined_loss_gradients_and_step_match_the_references(runs, case):
    ref, ref_meta, ours, meta = runs
    model = CASES[case][0]
    assert meta[case]["pipelined"]
    want = ref_meta[model]
    assert _rel(meta[case]["loss"], want["loss"]) <= LOSS_TOL
    assert _rel(meta[case]["step_loss"], want["loss"]) <= LOSS_TOL
    assert _rel(meta[case]["grad_norm"], want["grad_norm"]) <= NORM_TOL
    assert _misses(ours, ref, case, model, "grad", GRAD_TOL) == []
    assert _misses(ours, ref, case, model, "mu", STEP_TOL) == []
    assert _misses(ours, ref, case, model, "step", STEP_TOL) == []


def test_pipelined_loss_in_bfloat16_within_the_references_limit(runs):
    _, ref_meta, _, meta = runs
    assert meta["bf16"]["pipelined"]
    assert _rel(meta["bf16"]["loss"],
                ref_meta[BF16_CASE[0]]["loss"]) <= BF16_LOSS_TOL


def test_a_config_the_pipeline_does_not_take_trains_plainly(runs):
    ref, ref_meta, ours, meta = runs
    model = PLAIN_CASE[0]
    assert not meta["plain"]["pipelined"]
    assert _rel(meta["plain"]["loss"], ref_meta[model]["loss"]) <= LOSS_TOL
    assert _misses(ours, ref, "plain", model, "grad", GRAD_TOL) == []


@pytest.mark.parametrize("case", [c for c, (_, dm) in CASES.items()
                                  if dm[1] > 1])
def test_fsdp_collectives_of_a_pipelined_step_are_the_dry_runs(runs, case):
    fsdp = runs[3][case]["fsdp"]
    got = sorted((op, n) for op, n, _ in fsdp["got"])
    want = sorted((op, n) for op, n, _ in fsdp["want"])
    assert len(got) > 0 and got == want


def test_the_controls_miss(runs):
    ref, ref_meta, ours, meta = runs
    # the whole-over-pod gradients not summed over pod
    assert _misses(ours, ref, "control_sync", "granite", "grad", GRAD_TOL)
    # their squares counted on every stage
    assert _rel(meta["control_norm"]["grad_norm"],
                ref_meta["granite"]["grad_norm"]) > NORM_TOL


if __name__ == "__main__":
    {"port": port_main}[sys.argv[1]](*sys.argv[2:])
