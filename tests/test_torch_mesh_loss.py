"""The port's loss and gradients on a (data, model) mesh of 4 gloo ranks
against the reference's single-device ``jax.value_and_grad`` of
``lm.loss_fn`` with ``num_groups`` = the data-parallel size (GSPMD keeps
semantics, and the reference's own mesh paths fail on the installed jax:
ROADMAP.md, Queue 3).

The fixture computes the reference's numbers in the pytest process (one
JAX CPU device) and writes them, with its weights by the port's names, to
an ``.npz``; then it runs this file as a script,

    python tests/test_torch_mesh_loss.py port IN.npz OUT.npz

which spawns 4 gloo ranks (``torch.multiprocessing``, a FileStore, one
thread each; they never import JAX). Each case lays the LM out through
the ``Trainer`` (tensor parallelism over ``model``, FSDP2 over ``data``),
takes this rank's rows of the batch, runs ``loss_fn`` and its backward,
and gathers every gradient whole (the trainer's checkpoint layout).

Cases: granite-8b smoke on (2, 2) (the reference's own
``check_sharded_train_equivalence`` case) and on (1, 4) (4-way heads, the
2 K/V heads whole on every rank: the GQA case), granite-3-2b smoke on
(1, 4) (a tied embedding whose padded vocab, 768 for 515, leaves pad
columns in two of the four blocks), an ``fftconv_mlp`` smoke LM on (2, 2)
(the channel-parallel mixer), phi3.5-moe smoke on (4, 1) with 4 MoE
groups, on (2, 2, 1) (pod, data, model), where FSDP runs over the
flattened (pod, data) ranks, and with 2 experts on (2, 2) (E/tp = 1 < dp:
each expert block cut along ``moe_d`` over the data ranks, as the
reference's is), and zamba2 smoke on (2, 2) (Mamba2 by heads, the shared
attention block at its place; tests/test_torch_mesh_kinds.py has the
other kinds). Every case records each parameter's FSDP2 placement
against ``runtime.trainer.fsdp_dims`` and, with a dispatch mode, every
op of ``loss_fn`` and its backward that yields a tensor whose last dim
is the padded vocab: none where ``model`` > 1 cuts the vocab (the
vocab-parallel embedding, head and cross-entropy); a control runs the
whole-vocab path (``forward``'s gathered logits into the same
cross-entropy) and must show them. Limits:
``_lm_parity``'s, the loss within 1e-5 of |ref| and each gradient within
1e-4 of its max|ref|. A control
drops the row all-reduce of tensor parallelism and must miss them. zamba2
and xlstm (Mamba2 with the shared attention block; mLSTM and sLSTM) on
(4, 1) are held against the port's own loss on one device at the same
limits (FSDP over every layer kind).
"""

import dataclasses
import datetime
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
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4           # _lm_parity's LOSS_TOL, F32_TOL
BATCH, SEQ, SEED = 4, 16, 3

# name -> (arch, config changes, mesh shape: (data, model) or (pod, data,
# model))
CASES = {
    "granite_2x2": ("granite_8b", {}, (2, 2)),
    "granite_1x4": ("granite_8b", {}, (1, 4)),
    "fftconv_2x2": ("olmo_1b", {"segments": (("fftconv_mlp", 2),)}, (2, 2)),
    "phi_4x1": ("phi35_moe_42b", {}, (4, 1)),
    "phi_2x2x1": ("phi35_moe_42b", {}, (2, 2, 1)),   # (pod, data, model)
    "phi_e2_2x2": ("phi35_moe_42b", {"num_experts": 2}, (2, 2)),
    "zamba2_2x2": ("zamba2_7b", {}, (2, 2)),
    "granite32_1x4": ("granite_3_2b", {}, (1, 4)),
}
KINDS = {"zamba2_4x1": ("zamba2_7b", (4, 1)),
         "xlstm_4x1": ("xlstm_1_3b", (4, 1))}
F32 = {"compute_dtype": "float32"}


# ---------------------------------------------------------------------------
# the port's run (4 gloo ranks; no JAX)
# ---------------------------------------------------------------------------


def _tensors(batch):
    import torch
    return {k: torch.from_numpy(np.array(v)).long()
            if k in ("tokens", "labels") else torch.from_numpy(np.array(v))
            for k, v in batch.items()}


def _mesh(dm):
    """A (data, model) or (pod, data, model) mesh of every rank."""
    from repro_torch.core.comm import make_mesh
    names = ("data", "model") if len(dm) == 2 else ("pod", "data", "model")
    return make_mesh(dm, names)


def _whole_vocab_ops(vocab, d_model, rows):
    """A dispatch mode whose ``seen`` lists (op, shape) of every op output
    that is a whole-vocab tensor: its last dim ``vocab`` and the shape of
    logits or of a head (at least 3 dims, or a first dim of ``d_model`` or
    of ``rows``, the positions), or the shape (``vocab``, ``d_model``) of
    an embedding table gathered whole. FSDP2's flat buffers, viewed
    (dp, n), are none of these."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    def whole(t):
        if not isinstance(t, torch.Tensor) or not t.dim():
            return False
        if tuple(t.shape) == (vocab, d_model):
            return True
        return t.shape[-1] == vocab and (t.dim() >= 3
                                         or t.shape[0] in (d_model, rows))

    class Watch(TorchDispatchMode):
        seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.seen += [(str(func), tuple(t.shape))
                          for t in tree_leaves(out) if whole(t)]
            return out
    return Watch()


def _whole_vocab_loss(model, batch, num_groups):
    """The control: ``forward``'s whole logits into the cross-entropy of
    a model whose vocab is whole."""
    from repro_torch.models import lm
    logits, _ = model(batch, num_groups)
    model.vocab_cut = lambda: False
    try:
        total, count = lm.token_nll_sum(model, logits, batch["labels"])
    finally:
        del model.vocab_cut
    return total / count.clamp(min=1.0)


def _placement(model, tr):
    """{name: [FSDP2 dim, fsdp_dims's dim, local shape]} of each
    parameter."""
    from repro_torch.runtime.trainer import fsdp_dims
    want = fsdp_dims(tr.mesh, tr.meta, tr.rules)
    return {n: [p.placements[0].dim, want[n], list(p.to_local().shape)]
            for n, p in model.named_parameters()}


def _mesh_case(cfg, weights, dm, tmp, control=False):
    """(loss, nll, aux, {name: whole gradient}, the whole-vocab ops of the
    loss and its backward, the placements) of ``cfg`` laid out on the mesh
    ``dm`` of every rank (``_mesh``), from ``weights`` by name; with
    ``control``, the loss of ``_whole_vocab_loss``."""
    import torch
    from repro_torch.models import LM, loss_fn
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.lm import padded_vocab
    from repro_torch.runtime import Trainer, TrainerConfig
    whole = LM(cfg, device="cpu")
    if weights is not None:
        with torch.no_grad():
            for name, p in whole.named_parameters():
                p.copy_(torch.from_numpy(weights[name]))
    tr = Trainer(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                 _mesh(dm),
                 TrainerConfig(ckpt_dir=str(tmp), seed=SEED), model=whole)
    model, _, _ = tr.init_state()
    batch = tr.batch_at(0)
    watch = _whole_vocab_ops(padded_vocab(cfg), cfg.d_model,
                             batch["labels"].numel())
    with watch:
        if control:
            loss = _whole_vocab_loss(model, batch, tr.num_groups)
            metrics = {"nll": loss, "aux": loss}
        else:
            loss, metrics = loss_fn(model, batch, tr.num_groups)
        loss.backward()
    grads = {n: tr.shardings["params"][n].gather(p.grad).numpy()
             for n, p in model.named_parameters()}
    return (float(loss), float(metrics["nll"]), float(metrics["aux"]),
            grads, watch.seen, _placement(model, tr))


def _port_rank(rank, store_path, in_path, out_path):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch import configs
    from repro_torch.data import SyntheticDataset
    from repro_torch.models import LM, blocks, loss_fn
    from repro_torch.models.config import ShapeConfig
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    tmp = Path(out_path).parent / f"ckpt{rank}"
    ref = np.load(in_path)
    out, meta = {}, {}

    def cfg_of(arch, changes):
        return dataclasses.replace(configs.get_smoke_config(arch),
                                   **dict(F32, **changes))

    for name, (arch, changes, dm) in CASES.items():
        weights = {k.split("/", 2)[2]: ref[k] for k in ref.files
                   if k.startswith(f"{name}/param/")}
        loss, nll, aux, grads, seen, placed = _mesh_case(
            cfg_of(arch, changes), weights, dm, tmp)
        ranks = [None] * WORLD
        dist.all_gather_object(ranks, placed)
        meta[name] = dict(loss=loss, nll=nll, aux=aux, whole_vocab=seen,
                          placed=ranks)
        out.update({f"{name}/grad/{k}": v for k, v in grads.items()})

    # the control: tensor parallelism without the row all-reduce
    arch, changes, dm = CASES["granite_2x2"]
    weights = {k.split("/", 2)[2]: ref[k] for k in ref.files
               if k.startswith("granite_2x2/param/")}
    reduce = blocks.TensorParallel.reduce
    blocks.TensorParallel.reduce = lambda self, y, dtype: y
    try:
        loss, _, _, grads, _, _ = _mesh_case(cfg_of(arch, changes), weights,
                                             dm, tmp)
    finally:
        blocks.TensorParallel.reduce = reduce
    meta["control"] = dict(loss=loss)
    out.update({f"control/grad/{k}": v for k, v in grads.items()})

    # the whole-vocab control: the same loss, whole-vocab tensors in it
    for name in ("granite_2x2", "granite_1x4"):
        arch, changes, dm = CASES[name]
        weights = {k.split("/", 2)[2]: ref[k] for k in ref.files
                   if k.startswith(f"{name}/param/")}
        loss, _, _, _, seen, _ = _mesh_case(cfg_of(arch, changes), weights,
                                            dm, tmp, control=True)
        meta[f"whole_vocab_{name}"] = dict(loss=loss, seen=seen)

    # every layer kind under FSDP, against the port on one device
    for name, (arch, dm) in KINDS.items():
        cfg = cfg_of(arch, {})
        loss, nll, aux, grads, _, _ = _mesh_case(cfg, None, dm, tmp)
        single = LM(cfg, device="cpu")
        batch = SyntheticDataset(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                                 SEED).batch_at(0)
        want, _ = loss_fn(single, _tensors(batch), dm[0])
        want.backward()
        meta[name] = dict(loss=loss, want=float(want))
        worst = max(float(np.abs(grads[n] - p.grad.numpy()).max()
                          / np.abs(p.grad.numpy()).max())
                    for n, p in single.named_parameters())
        meta[name]["worst_grad"] = worst
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
    """The reference's loss, metrics and gradients of each case on one
    device (``num_groups`` = the data axis), and its weights, by the
    port's names."""
    import jax
    import jax.numpy as jnp
    from repro.data import SyntheticDataset as RData
    from repro.models import lm as rlm
    from repro.models.config import ShapeConfig as RShape
    from repro_torch.convert import flatten_reference
    from _lm_parity import cfgs, to_np
    arrays, meta = {}, {}
    for name, (arch, changes, dm) in CASES.items():
        dp = int(np.prod(dm[:-1]))
        rc, _ = cfgs(arch, **dict(F32, **changes))
        batch = RData(rc, RShape("t", SEQ, BATCH, "train"),
                      seed=SEED).batch_at(0)
        params = rlm.init_params(rc, jax.random.key(0))
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p, x: rlm.loss_fn(p, rc, x, dp), has_aux=True))(
                params, {k: jnp.asarray(v) for k, v in batch.items()})
        meta[name] = dict(loss=float(loss), nll=float(metrics["nll"]),
                          aux=float(metrics["aux"]))
        for k, v in flatten_reference(to_np(params), rc).items():
            arrays[f"{name}/param/{k}"] = np.asarray(v, np.float32)
        for k, v in flatten_reference(to_np(grads), rc).items():
            arrays[f"{name}/grad/{k}"] = np.asarray(v, np.float32)
    np.savez(tmp / "ref.npz", **arrays)
    return arrays, meta


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_loss")
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


def _misses(ours, ref, prefix, case):
    """The gradients of ``prefix`` beyond the limit of case's reference."""
    out = []
    for k in ref:
        if k.startswith(f"{case}/grad/"):
            name = k.split("/", 2)[2]
            got, want = ours[f"{prefix}/grad/{name}"], ref[k]
            assert got.shape == want.shape, (name, got.shape, want.shape)
            if np.abs(got - want).max() > GRAD_TOL * np.abs(want).max():
                out.append(name)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradients_match_the_references(runs, case):
    ref, ref_meta, ours, meta = runs
    for key in ("loss", "nll", "aux"):
        want = ref_meta[case][key]
        assert abs(meta[case][key] - want) <= LOSS_TOL * abs(want), (
            key, meta[case][key], want)
    assert _misses(ours, ref, case, case) == []


@pytest.mark.parametrize("case", [c for c, (_, _, dm) in CASES.items()
                                  if dm[-1] > 1])
def test_no_op_of_the_loss_yields_a_whole_vocab_tensor(runs, case):
    assert runs[3][case]["whole_vocab"] == []


@pytest.mark.parametrize("case", ["granite_2x2", "granite_1x4"])
def test_the_whole_vocab_path_shows_whole_vocab_tensors(runs, case):
    ref_meta, meta = runs[1], runs[3]
    control = meta[f"whole_vocab_{case}"]
    # the same loss (no aux loss in a dense model), whole-vocab tensors
    assert abs(control["loss"] - ref_meta[case]["loss"]) <= LOSS_TOL * abs(
        ref_meta[case]["loss"])
    assert any(shape[-1] == 512 and len(shape) == 3
               for _, shape in control["seen"]), control["seen"][:5]


@pytest.mark.parametrize("case", list(CASES))
def test_fsdp2_cuts_each_parameter_along_the_rules_dim(runs, case):
    for rank, placed in enumerate(runs[3][case]["placed"]):
        for name, (got, want, _) in placed.items():
            assert got == want, (rank, name, got, want)


def test_two_experts_on_2x2_are_cut_along_moe_d_on_both_data_ranks(runs):
    from repro_torch import configs
    d = configs.get_smoke_config("phi35_moe_42b").d_model
    placed = runs[3]["phi_e2_2x2"]["placed"]
    experts = [n for n in placed[0] if ".moe.w_" in n]
    assert experts
    for rank, by_name in enumerate(placed):      # ranks (data, model) 2 x 2
        for name in experts:
            dim, _, shape = by_name[name]
            assert dim == (2 if name.endswith("w_down") else 1), name
            # one expert a model rank, half its d on each data rank
            assert shape[0] == 1 and shape[dim] == d // 2, (rank, name,
                                                             shape)


def test_tensor_parallelism_without_the_row_all_reduce_misses(runs):
    ref, ref_meta, ours, meta = runs
    want = ref_meta["granite_2x2"]["loss"]
    assert abs(meta["control"]["loss"] - want) > LOSS_TOL * abs(want)
    assert _misses(ours, ref, "control", "granite_2x2")


@pytest.mark.parametrize("case", list(KINDS))
def test_fsdp_trains_the_recurrent_kinds_as_one_device_does(runs, case):
    meta = runs[3][case]
    assert abs(meta["loss"] - meta["want"]) <= LOSS_TOL * abs(meta["want"])
    assert meta["worst_grad"] <= GRAD_TOL


if __name__ == "__main__":
    {"port": port_main}[sys.argv[1]](*sys.argv[2:])
