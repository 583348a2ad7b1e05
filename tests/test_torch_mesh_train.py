"""The port's ``Trainer`` and training CLI on a (data, model) mesh of 4
gloo ranks, against the reference's one-device ``Trainer`` and against
the port's own runs.

The fixture runs the reference's ``Trainer`` for 4 steps in the pytest
process (one JAX CPU device) from its weights, and writes those weights
by the port's names and its losses to an ``.npz``; then it runs this file
as a script,

    python tests/test_torch_mesh_train.py port IN.npz OUT_DIR

which spawns 4 gloo ranks (``torch.multiprocessing``, a FileStore, one
thread each; they never import JAX). On them:

* a (2, 2) ``Trainer`` (tensor parallelism over ``model``, FSDP2 over
  ``data``) from the reference's weights, 4 steps, a checkpoint at steps
  2 and 4: its losses within 1e-5 of |ref| of the reference's, its final
  parameters within ``RUN_PARAM_TOL`` (test_torch_train.py) of its;
* its step-2 checkpoint restored on (2, 1) (ranks 0-1) and on one device
  (rank 0), each trained on to step 4: the losses of steps 3-4 within
  1e-5 of the uninterrupted run's;
* the AdamW moments: each rank holds its block (at most 1/dp of every
  tensor), and ``grad_accum=2`` on (2, 2) lands within the tolerance of
  tests/test_trainer_features.py of one batch;
* ``launch.train.main(["--mesh", "local", "--data-axis", "2", ...])`` on
  the 4 ranks: rank 0 alone prints the reference's JSON summary.
"""

import dataclasses
import datetime
import io
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

pytestmark = pytest.mark.slow

ROOT = Path(__file__).resolve().parents[1]
RUN_TIMEOUT = 300       # seconds; the ranks take about 20 s
WORLD = 4
LOSS_TOL, RUN_PARAM_TOL = 1e-5, 1e-3
ARCH, BATCH, SEQ, STEPS = "granite_8b", 4, 32, 4
OPT = dict(warmup_steps=2, total_steps=50)


def _cfg():
    from repro_torch import configs
    return dataclasses.replace(configs.get_smoke_config(ARCH),
                               compute_dtype="float32")


def _trainer(mesh, ckpt_dir, model=None, **tcfg):
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    return Trainer(_cfg(), ShapeConfig("t", SEQ, BATCH, "train"), mesh,
                   TrainerConfig(ckpt_dir=str(ckpt_dir), ckpt_every=2,
                                 **tcfg),
                   AdamWConfig(**OPT), device="cpu", model=model)


def _from_step_2(src, dst):
    """A checkpoint directory holding ``src``'s step 2 alone."""
    os.makedirs(dst)
    for suffix in ("", ".json"):
        shutil.copy(os.path.join(src, "step_00000002.npz" + suffix), dst)
    with open(os.path.join(dst, "latest"), "w") as f:
        f.write("2")


def _port_rank(rank, store_path, in_path, out_dir):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.core.comm import make_mesh
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import LM, param_count
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    out_dir = Path(out_dir)
    ref = np.load(in_path)
    whole = LM(_cfg(), device="cpu")
    with torch.no_grad():
        for name, p in whole.named_parameters():
            p.copy_(torch.from_numpy(ref[f"param/{name}"]))
    meta, arrays = {}, {}

    # (2, 2) from the reference's weights, checkpoints at steps 2 and 4
    mesh = make_local_mesh(2, 2)
    tr = _trainer(mesh, out_dir / "run22", model=whole)
    model, opt, hist = tr.run(STEPS)
    meta["run22"] = [h["loss"] for h in hist]
    for name, p in model.named_parameters():
        full = tr.shardings["params"][name].gather(p)
        if rank == 0:
            arrays[f"param/{name}"] = full.detach().numpy()
    numel = [None] * WORLD
    dist.all_gather_object(numel, sum(t.numel() for t in opt["mu"].values()))
    meta["numel"] = [numel, param_count(tr.meta)]

    # grad_accum 2 on the same mesh against one batch, from the seed
    a1 = _trainer(mesh, out_dir / f"acc1_{rank}")
    a2 = _trainer(mesh, out_dir / f"acc2_{rank}", grad_accum=2)
    m1, _, _ = a1.run(2)
    m2, _, _ = a2.run(2)
    worst = 0.0
    for (n, p1), p2 in zip(m1.named_parameters(), m2.parameters()):
        x, y = p1.to_local(), p2.to_local()
        if x.numel():
            worst = max(worst, float(((x - y).abs() - 2e-4 * y.abs())
                                     .max()))
    meta["accum"] = [None] * WORLD
    dist.all_gather_object(meta["accum"], worst)

    # step 2 restored on (2, 1) (ranks 0-1) and on one device (rank 0)
    if rank == 0:
        _from_step_2(out_dir / "run22", out_dir / "run21")
        _from_step_2(out_dir / "run22", out_dir / "run1")
    dist.barrier()
    mesh21 = make_mesh((2, 1), ("data", "model"), ranks=[0, 1])
    if mesh21 is not None:
        _, _, hist = _trainer(mesh21, out_dir / "run21").run(STEPS)
        meta["run21"] = [h["loss"] for h in hist]
    if rank == 0:
        _, _, hist = _trainer(None, out_dir / "run1").run(STEPS)
        meta["run1"] = [h["loss"] for h in hist]
    dist.barrier()

    # the CLI: rank 0 alone prints
    buf = io.StringIO()
    with redirect_stdout(buf):
        launch_train.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
                           "--mesh", "local", "--data-axis", "2", "--steps",
                           "2", "--batch", "4", "--seq", "16"])
    meta["cli"] = [None] * WORLD
    dist.all_gather_object(meta["cli"], buf.getvalue())
    if rank == 0:
        np.savez(out_dir / "port.npz", meta=json.dumps(meta), **arrays)
    dist.barrier()
    dist.destroy_process_group()


def port_main(in_path, out_dir):
    import torch.multiprocessing as mp
    store = os.path.join(out_dir, "gloo_store")
    mp.start_processes(_port_rank, args=(store, in_path, out_dir),
                       nprocs=WORLD, start_method="spawn")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    from repro.models import lm as rlm
    from repro.models.config import ShapeConfig as RShape
    from repro.optim import AdamWConfig as ROpt
    from repro.runtime import Trainer as RTrainer
    from repro.runtime import TrainerConfig as RTrainerConfig
    from repro_torch.convert import flatten_reference
    from _lm_parity import cfgs, to_np
    tmp = tmp_path_factory.mktemp("mesh_train")
    rc, _ = cfgs(ARCH, compute_dtype="float32")
    params = rlm.init_params(rc, jax.random.key(0))
    arrays = {f"param/{k}": np.asarray(v, np.float32) for k, v in
              flatten_reference(to_np(params), rc).items()}
    ref = RTrainer(rc, RShape("t", SEQ, BATCH, "train"), None,
                   RTrainerConfig(ckpt_dir=str(tmp / "ref"), ckpt_every=100),
                   ROpt(**OPT))
    ref_params, _, hist = ref.run(STEPS)
    final = flatten_reference(to_np(ref_params), rc)
    np.savez(tmp / "ref.npz", **arrays)
    proc = subprocess.run(
        [sys.executable, __file__, "port", str(tmp / "ref.npz"), str(tmp)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=RUN_TIMEOUT)
    assert proc.returncode == 0, proc.stdout
    z = np.load(tmp / "port.npz")
    return ([h["loss"] for h in hist], final,
            {k: z[k] for k in z.files if k != "meta"},
            json.loads(str(z["meta"])))


def test_a_2x2_trainer_matches_the_references(runs):
    ref_losses, ref_final, ours, meta = runs
    assert len(meta["run22"]) == len(ref_losses) == STEPS
    for got, want in zip(meta["run22"], ref_losses):
        assert abs(got - want) <= LOSS_TOL * abs(want), (got, want)
    for name, want in ref_final.items():
        got = ours[f"param/{name}"]
        assert got.shape == want.shape, name
        assert np.abs(got - want).max() <= RUN_PARAM_TOL * np.abs(
            want).max(), name


@pytest.mark.parametrize("where", ["run21", "run1"])
def test_a_2x2_checkpoint_resumes_on_another_mesh(runs, where):
    meta = runs[3]
    resumed, uninterrupted = meta[where], meta["run22"][2:]
    assert len(resumed) == STEPS - 2
    for got, want in zip(resumed, uninterrupted):
        assert abs(got - want) <= LOSS_TOL * abs(want), (where, got, want)


def test_moments_are_sharded_over_data(runs):
    numel, total = runs[3]["numel"]
    for rank, local in enumerate(numel):
        # at most 1/dp of every tensor (1/(dp*tp) of the split ones); the
        # first-dim blocks round up by a row a tensor at most
        assert total / 4 <= local < total / 2, (rank, local, total)


def test_grad_accum_on_a_mesh_matches_one_batch(runs):
    assert max(runs[3]["accum"]) <= 2e-5, runs[3]["accum"]


def test_the_launcher_trains_on_4_ranks_and_prints_once(runs):
    printed = runs[3]["cli"]
    summary = json.loads(printed[0])
    assert summary["steps"] == 2 and np.isfinite(summary["last_loss"])
    assert printed[1:] == [""] * (WORLD - 1)


if __name__ == "__main__":
    {"port": port_main}[sys.argv[1]](*sys.argv[2:])
