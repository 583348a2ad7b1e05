"""The port's training path (repro_torch: fft_conv's backward, lm.loss_fn,
optim.adamw, data.pipeline, checkpoint.manager, runtime.trainer,
launch.train) against the reference's (repro) on the CPU, in float32.

Inputs are numpy arrays from a seed; the reference's weights and AdamW
state come across through ``convert.lm_from_reference`` and
``convert.adamw_state_from_reference``. Tolerances:

* ``fft_conv``'s gradients: 1e-4 of max|ref| (the reference's kernel
  tolerance, tests/test_kernels.py);
* the loss: 1e-5 of |ref|, each parameter's gradient 1e-4 of that
  gradient's max|ref| (``_lm_parity.loss_parity``);
* ``adamw_update``: 1e-6 of max|ref| per tensor (the same float32
  arithmetic);
* a Trainer run against the reference's: per-step losses within 1e-6 of
  |ref| (measured 9e-8); the final parameters within 1e-3 of max|ref| per
  tensor (measured 5e-5). AdamW's first steps move each element by about
  lr whatever its gradient's size, so an element whose gradient is at the
  float32 noise floor can land up to 2 lr = 6e-4 (7e-3 of these
  tensors' max) away; the limit sits between the two;
* on the port alone: grad_accum 4 against 1 at the reference's own
  tolerance (tests/test_trainer_features.py); a restart bit for bit.
"""

import dataclasses
import json
import os
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fftconv as jfc
from repro.data import SyntheticDataset as RData
from repro.models import lm as rlm
from repro.models.config import ArchConfig as RArch
from repro.models.config import ShapeConfig as RShape
from repro.optim import AdamWConfig as ROpt
from repro.optim import adamw_init as radamw_init
from repro.optim import adamw_update as radamw_update
from repro.runtime import Trainer as RTrainer
from repro.runtime import TrainerConfig as RTrainerConfig
from repro_torch import Planner
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import (adamw_state_from_reference,
                                 flatten_reference, lm_from_reference)
from repro_torch.core import fftconv as fc
from repro_torch.data import SyntheticDataset
from repro_torch.launch import train as launch_train
from repro_torch.models import LM, loss_fn
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule, global_norm)
from repro_torch.runtime import Trainer, TrainerConfig

from _lm_parity import F32_TOL, cfgs, close, loss_parity, tensors, to_np

RNG = np.random.default_rng(19)
ADAMW_TOL, RUN_LOSS_TOL, RUN_PARAM_TOL = 1e-6, 1e-6, 1e-3
TINY = dict(name="tiny", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
            compute_dtype="float32")
SHAPE = ShapeConfig("smoke", 32, 4, "train")
OPT = AdamWConfig(warmup_steps=2, total_steps=50)


def _tiny(**changes):
    return ArchConfig(**dict(TINY, **changes))


def _trainer(d, every=3, cfg=None, shape=SHAPE, **tcfg):
    return Trainer(cfg or _tiny(), shape, None,
                   TrainerConfig(ckpt_dir=str(d), ckpt_every=every, **tcfg),
                   OPT, device="cpu")


# -- fft_conv's backward -----------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("permuted", [True, False])
def test_fft_conv_gradients_match_the_reference_vjp(backend, permuted):
    # hopper runs the four-step kernel's plain version here; the gradients
    # of u and k against jax.vjp of the reference's fft_conv
    u = RNG.standard_normal((3, 40, 6)).astype(np.float32)
    k = RNG.standard_normal((6, 40)).astype(np.float32)
    g = RNG.standard_normal((3, 40, 6)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jfc.fft_conv(a, b, permuted=permuted),
                     jnp.asarray(u), jnp.asarray(k))
    want_u, want_k = vjp(jnp.asarray(g))
    ut = torch.from_numpy(u).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    y = fc.fft_conv(ut, kt, planner=Planner(backends=(backend,)),
                    permuted=permuted, device="cpu")
    y.backward(torch.from_numpy(g))
    close(ut.grad, np.asarray(want_u), F32_TOL, "grad_u")
    close(kt.grad, np.asarray(want_k), F32_TOL, "grad_k")


def test_fft_conv_gradients_come_back_in_the_inputs_dtypes():
    u = torch.randn(2, 16, 4, dtype=torch.bfloat16, requires_grad=True)
    k = torch.randn(4, 16, requires_grad=True)
    fc.fft_conv(u, k, device="cpu").sum().backward()
    assert u.grad.dtype == torch.bfloat16 and k.grad.dtype == torch.float32
    # only the inputs that require grad get one
    v = torch.randn(2, 16, 4, requires_grad=True)
    fc.fft_conv(v, torch.randn(4, 16), device="cpu").sum().backward()
    assert v.grad is not None


def test_the_sharded_conv_refuses_grad_naming_the_queue():
    # it refused grad until its backward was ported; now, on a one-rank
    # gloo mesh, its gradients are fft_conv's (tests/test_torch_dist.py
    # holds them on 2 and 4 ranks)
    import datetime

    import torch.distributed as dist
    from repro_torch.core.comm import make_mesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh((1,), ("fft",))
        u = torch.randn(2, 16, 3, requires_grad=True)
        k = torch.randn(3, 16, requires_grad=True)
        w = torch.randn(2, 16, 3)
        (fc.fft_conv_seq_sharded(u, k, mesh, "fft") * w).sum().backward()
        ug, kg = u.grad, k.grad
        u.grad = k.grad = None
        (fc.fft_conv(u, k, device="cpu") * w).sum().backward()
        close(ug, u.grad.numpy(), F32_TOL, "grad_u")
        close(kg, k.grad.numpy(), F32_TOL, "grad_k")
    finally:
        dist.destroy_process_group()


def test_remat_recomputes_each_fft_conv_once_more(monkeypatch):
    # each layer's forward runs twice with remat (the recompute saves the
    # spectra), once without: forward transforms 2 + 2 a layer, backward 1
    calls = []
    spectrum = fc._spectrum
    monkeypatch.setattr(fc, "_spectrum",
                        lambda *a: calls.append(1) or spectrum(*a))
    cfg = _tiny(segments=(("fftconv_mlp", 2),))
    batch = tensors(SyntheticDataset(cfg, SHAPE).batch_at(0))
    grads = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        model = LM(c, device="cpu")
        calls.clear()
        loss_fn(model, batch)[0].backward()
        assert len(calls) == (5 if remat else 3) * 2
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
    for n, g in grads[True].items():
        assert torch.equal(g, grads[False][n]), n
    with pytest.raises(NotImplementedError, match="offload"):
        loss_fn(LM(dataclasses.replace(cfg, remat_policy="offload"),
                   device="cpu"), batch)


# -- the loss and its gradients ----------------------------------------------

LOSS_CASES = [("olmo_1b", "olmo_1b", {}),
              ("fftconv", "olmo_1b", dict(segments=(("fftconv_mlp", 2),))),
              ("phi35_moe", "phi35_moe_42b", {})]


@pytest.mark.parametrize("name,arch,changes", LOSS_CASES,
                         ids=[c[0] for c in LOSS_CASES])
def test_loss_and_gradients_match_the_reference(name, arch, changes):
    aux = loss_parity(arch, changes)
    assert (aux > 0) == (name == "phi35_moe")   # the aux term is exercised


# -- AdamW --------------------------------------------------------------------


def test_adamw_matches_the_reference_over_warmup_and_cosine():
    # warmup 2 of 4 steps: steps 1-2 warm up, step 3 is on the cosine;
    # gradients of norm about 8 against clip_norm 0.5, so every step clips
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=4, clip_norm=0.5)
    shapes = {"a": (5, 7), "b": (11,), "c": (2, 3, 4)}
    params = {n: RNG.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    ref_p = {n: jnp.asarray(a) for n, a in params.items()}
    ref_s = radamw_init(ref_p)
    ours_p = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    ours_s = adamw_init(ours_p)
    for step in range(3):
        grads = {n: 2.0 * RNG.standard_normal(s).astype(np.float32)
                 for n, s in shapes.items()}
        ref_p, ref_s, ref_m = radamw_update(
            ROpt(**kw), {n: jnp.asarray(g) for n, g in grads.items()},
            ref_p, ref_s)
        ours_p, ours_s, m = adamw_update(
            AdamWConfig(**kw), {n: torch.from_numpy(g)
                                for n, g in grads.items()}, ours_p, ours_s)
        assert float(ref_m["grad_norm"]) > 0.5 * 4     # clipping is active
        assert int(ours_s["step"]) == int(ref_s["step"]) == step + 1
        for name in ("grad_norm", "lr"):
            assert abs(float(m[name]) - float(ref_m[name])) <= ADAMW_TOL * \
                abs(float(ref_m[name])), name
        for n in shapes:
            close(ours_p[n], np.asarray(ref_p[n]), ADAMW_TOL, f"p {n} {step}")
            close(ours_s["mu"][n], np.asarray(ref_s["mu"][n]), ADAMW_TOL,
                  f"mu {n} {step}")
            close(ours_s["nu"][n], np.asarray(ref_s["nu"][n]), ADAMW_TOL,
                  f"nu {n} {step}")


def test_cosine_schedule_and_global_norm_match_the_reference():
    from repro.optim.adamw import cosine_schedule as rcos
    from repro.optim.adamw import global_norm as rnorm
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for step in (0, 1, 5, 10, 11, 55, 100, 150):
        want = float(rcos(ROpt(**cfg), jnp.asarray(step)))
        got = float(cosine_schedule(AdamWConfig(**cfg), torch.tensor(step)))
        assert abs(got - want) <= ADAMW_TOL * max(abs(want), 1e-12), step
    tree = {"a": RNG.standard_normal((4, 5)).astype(np.float32),
            "b": RNG.standard_normal(7).astype(np.float32)}
    want = float(rnorm({k: jnp.asarray(v) for k, v in tree.items()}))
    got = float(global_norm({k: torch.from_numpy(v) for k, v in tree.items()}))
    assert abs(got - want) <= ADAMW_TOL * want


def test_adamw_update_needs_a_gradient_for_every_parameter():
    p = {"a": torch.zeros(3)}
    with pytest.raises(ValueError, match="missing"):
        adamw_update(AdamWConfig(), {"b": torch.zeros(3)}, p, adamw_init(p))


# -- data ---------------------------------------------------------------------

DATA_CASES = [("olmo_1b", "train"), ("olmo_1b", "prefill"),
              ("olmo_1b", "decode"), ("qwen2_vl_7b", "train"),
              ("musicgen_large", "train"), ("musicgen_large", "decode")]


@pytest.mark.parametrize("arch,kind", DATA_CASES,
                         ids=[f"{a}-{k}" for a, k in DATA_CASES])
def test_batches_equal_the_references(arch, kind):
    rc, pc = cfgs(arch)
    for step in (0, 7):
        want = RData(rc, RShape("t", 24, 3, kind), seed=5).batch_at(step)
        got = SyntheticDataset(pc, ShapeConfig("t", 24, 3, kind),
                               seed=5).batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- the Trainer against the reference's --------------------------------------


@pytest.mark.parametrize("segments", [(), (("fftconv_mlp", 2),)],
                         ids=["dense", "fftconv"])
def test_a_trainer_run_matches_the_references(tmp_path, segments):
    # both start from the reference's weights and AdamW state (carried
    # across); four steps of the same batches
    rc = RArch(**dict(TINY, segments=segments))
    pc = _tiny(segments=segments)
    rshape, ropt = RShape("s", 32, 4, "train"), ROpt(warmup_steps=2,
                                                    total_steps=50)
    ref = RTrainer(rc, rshape, None, RTrainerConfig(
        ckpt_dir=str(tmp_path / "r"), ckpt_every=100), ropt)
    params = rlm.init_params(rc, jax.random.key(0))
    model = lm_from_reference(to_np(params), pc, device="cpu")
    opt = adamw_state_from_reference(to_np(radamw_init(params)), pc, model)
    ref_params, _, ref_hist = ref.run(4)
    ours = Trainer(pc, SHAPE, None, TrainerConfig(
        ckpt_dir=str(tmp_path / "p"), ckpt_every=100), OPT, device="cpu",
        model=model, opt_state=opt)
    model, _, hist = ours.run(4)
    assert len(hist) == len(ref_hist) == 4
    for got, want in zip(hist, ref_hist):
        assert sorted(got) == sorted(want)
        assert abs(got["loss"] - want["loss"]) <= RUN_LOSS_TOL * abs(
            want["loss"]), (got["loss"], want["loss"])
    want = flatten_reference(to_np(ref_params), rc)
    for name, p in model.named_parameters():
        close(p, want[name], RUN_PARAM_TOL, name)


def test_adamw_state_from_reference_maps_the_moments_by_name():
    rc, pc = cfgs("zamba2_7b")
    params = rlm.init_params(rc, jax.random.key(1))
    state = to_np(radamw_init(params))
    state["mu"] = jax.tree_util.tree_map(
        lambda a: RNG.standard_normal(a.shape).astype(np.float32),
        state["mu"])
    state["step"] = np.int32(7)
    model = lm_from_reference(to_np(params), pc, device="cpu")
    ours = adamw_state_from_reference(state, pc, model)
    want = flatten_reference(state["mu"], rc)
    assert set(ours["mu"]) == set(dict(model.named_parameters())) == \
        set(want)
    for n, t in ours["mu"].items():
        np.testing.assert_array_equal(t.numpy(), want[n], err_msg=n)
    assert ours["step"].dtype == torch.int32 and int(ours["step"]) == 7
    state["nu"] = {}
    with pytest.raises((ValueError, KeyError)):
        adamw_state_from_reference(state, pc, model)


# -- the Trainer on its own ---------------------------------------------------


def test_grad_accum_4_matches_the_full_batch(tmp_path):
    shape = ShapeConfig("t", 32, 8, "train")
    m1, _, h1 = _trainer(tmp_path / "a", 100, shape=shape).run(3)
    m4, _, h4 = _trainer(tmp_path / "b", 100, shape=shape,
                         grad_accum=4).run(3)
    for (n, a), b in zip(m1.named_parameters(), m4.parameters()):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5, msg=n)
    assert abs(h1[-1]["loss"] - h4[-1]["loss"]) < 1e-3


def test_restart_is_bit_identical(tmp_path):
    _trainer(tmp_path / "cut").run(3)                  # checkpoint at 3
    resumed = _trainer(tmp_path / "cut")
    m2, s2, h2 = resumed.run(6)                       # resumes 3..5
    m3, s3, h3 = _trainer(tmp_path / "clean", every=100).run(6)
    assert len(h2) == 3
    assert h2 == h3[3:]
    for (n, a), b in zip(m2.named_parameters(), m3.parameters()):
        assert torch.equal(a, b), n
    for m in ("mu", "nu"):
        for n, t in s2[m].items():
            assert torch.equal(t, s3[m][n]), (m, n)
    assert int(s2["step"]) == int(s3["step"]) == 6


def test_simulated_preemption_and_recovery(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PREEMPT_AT", "3")
    with pytest.raises(SystemExit, match="preemption"):
        _trainer(tmp_path).run(10)
    monkeypatch.delenv("REPRO_PREEMPT_AT")
    assert CheckpointManager(str(tmp_path)).latest_step() == 3
    _, _, h = _trainer(tmp_path).run(5)
    assert len(h) == 2                       # resumed at 3, ran 3..4


def test_straggler_watchdog_counts(tmp_path):
    t = _trainer(tmp_path)
    for i in range(5):
        t._watchdog(i, 0.1)
    t._watchdog(5, 10.0)                     # 100x the EWMA
    assert [e[0] for e in t.straggler_events] == [5]


def test_a_frontend_config_trains_and_a_mesh_raises(tmp_path):
    _, pc = cfgs("qwen2_vl_7b")
    tr = _trainer(tmp_path, 100, cfg=pc, shape=ShapeConfig("t", 16, 4,
                                                           "train"))
    _, _, hist = tr.run(2)
    assert all(np.isfinite(h["loss"]) for h in hist)
    # a mesh is a DeviceMesh (tests/test_torch_mesh_train.py trains on one)
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(pc, SHAPE, object(), TrainerConfig(str(tmp_path)),
                device="cpu")


def test_the_launcher_prints_the_references_summary(tmp_path, capsys):
    out = launch_train.main(["--arch", "olmo-1b", "--smoke", "--device",
                             "cpu", "--steps", "3", "--batch", "2", "--seq",
                             "16", "--ckpt-dir", str(tmp_path),
                             "--planner", "hopper"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == out and out["steps"] == 3
    assert sorted(out) == ["first_loss", "last_loss", "steps",
                           "straggler_events"]
    assert CheckpointManager(str(tmp_path)).latest_step() == 3
    # the production mesh needs its 256 ranks (tests/test_torch_mesh_train.py
    # trains on a local mesh of 4)
    with pytest.raises(ValueError, match="needs 256 ranks, got 1"):
        launch_train.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
                           "--mesh", "single"])


def test_the_launcher_starts_fresh_without_a_ckpt_dir(tmp_path, monkeypatch,
                                                      capsys):
    """Without --ckpt-dir each run trains all its steps in a new directory;
    a given directory already at --steps raises instead of summarising
    no steps."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--steps",
            "2", "--batch", "2", "--seq", "16"]
    assert [launch_train.main(argv)["steps"] for _ in "ab"] == [2, 2]
    dirs = sorted(tmp_path.iterdir())
    assert len(dirs) == 2
    assert [CheckpointManager(str(d)).latest_step() for d in dirs] == [2, 2]
    with pytest.raises(SystemExit, match="nothing to train"):
        launch_train.main(argv + ["--ckpt-dir", str(dirs[0])])
    capsys.readouterr()


# -- checkpoints --------------------------------------------------------------


def test_checkpoint_round_trip_keeps_every_dtype_bit_for_bit(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    tree = {"params": {"w": torch.randn(3, 4),
                       "h": torch.randn(5, dtype=torch.bfloat16)},
            "opt": {"step": torch.tensor(3, dtype=torch.int32),
                    "mu": {"w": torch.randn(3, 4)}}}
    mgr.save(1, tree, extra={"data_step": 1})
    mgr.wait()
    with open(tmp_path / "step_00000001.npz.json") as f:
        man = json.load(f)
    assert man["dtypes"]["params/h"] == "bfloat16"
    assert man["extra"] == {"data_step": 1}
    back, extra = mgr.restore(1, tree)
    assert extra == {"data_step": 1}
    flat = [("params", "w"), ("params", "h"), ("opt", "step")]
    for a, b in flat:
        assert back[a][b].dtype == tree[a][b].dtype
        assert torch.equal(back[a][b], tree[a][b]), (a, b)
    assert torch.equal(back["opt"]["mu"]["w"], tree["opt"]["mu"]["w"])
    # a tensor of another dtype, shape or key does not restore into it
    for like in ({**tree, "opt": {**tree["opt"], "step": torch.tensor(0)}},
                 {**tree, "params": {**tree["params"],
                                     "w": torch.zeros(4, 3)}},
                 {"params": tree["params"]}):
        with pytest.raises(ValueError):
            mgr.restore(1, like)


def test_checkpoint_writes_are_atomic_and_keep_n(tmp_path, monkeypatch):
    from repro_torch.checkpoint import manager

    # each write waits until the caller has gone on in place: what it
    # writes is the copy taken at save
    went_on = threading.Semaphore(0)
    savez = manager.np.savez

    def held(*args, **kwargs):
        went_on.acquire()
        return savez(*args, **kwargs)
    monkeypatch.setattr(manager.np, "savez", held)
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    tree = {"x": torch.arange(6.0)}
    for step in (1, 2, 3):
        mgr.save(step, tree)
        tree["x"].add_(100)
        went_on.release()
    mgr.wait()
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))
    for step in (2, 3):                 # each holds the values saved
        back, _ = mgr.restore(step, tree)
        assert torch.equal(back["x"], torch.arange(6.0) + 100 * (step - 1))
    # a torn write (a .tmp that was never replaced) is not a checkpoint,
    # and a stale "latest" falls back to the newest complete step
    (tmp_path / "step_00000009.npz.tmp").write_bytes(b"torn")
    (tmp_path / "latest").write_text("9")
    assert mgr.latest_step() == 3


def test_a_failed_background_write_raises_at_wait(tmp_path, monkeypatch):
    from repro_torch.checkpoint import manager

    def full_disk(*args, **kwargs):
        raise OSError("no space left on device")
    monkeypatch.setattr(manager.np, "savez", full_disk)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="write failed"):
        mgr.wait()
    mgr.wait()                          # reported once
    assert mgr.latest_step() is None
