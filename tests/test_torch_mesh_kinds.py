"""Tensor parallelism of the recurrent mixers (Mamba2, mLSTM, sLSTM),
zamba2's shared attention block and the embedding frontends (qwen2-vl's
M-RoPE, musicgen's sinusoids) on a (data, model) mesh of 4 gloo ranks,
against the reference on one device.

The fixture computes the reference's numbers in the pytest process (one
JAX CPU device, ``jax.jit``): for each smoke config, its ``prefill``
logits of a batch of 4 prompts, and ``jax.value_and_grad`` of its
``loss_fn`` on a ``SyntheticDataset`` batch with ``num_groups`` = 2 (the
(2, 2) mesh's data axis; GSPMD keeps semantics, and the reference's own
mesh paths fail on the installed jax: ROADMAP.md, Queue 3). It writes
them with the weights, by the port's names, to an ``.npz`` and runs this
file as a script,

    python tests/test_torch_mesh_kinds.py port IN.npz OUT.npz

which spawns 4 gloo ranks (``torch.multiprocessing``, a FileStore, one
thread each; they never import JAX). On them, each config is

* served on (1, 4) and (2, 2) at batch 4 and on (4, 1) at batch 1 (the
  flash-decoding layout): ``build_cell``'s decode cell places the LM, it
  prefills 8 positions and decodes 3 forced tokens through the cell's
  ``serve_step``, the caches kept float32 (a bfloat16 cache rounds k/v,
  whose last-bit differences would flip). The prefill's logits are held
  within 1e-5 of max against the reference's, and every logit (prefill
  and decode) within 1e-5 against the port's one-device LM on the same
  weights (the one-device decode is held against the reference by
  tests/test_torch_lm_kinds.py and test_torch_lm_embeds.py);
* trained one step on (2, 2) through the ``Trainer`` (tensor parallelism
  over ``model``, FSDP2 over ``data``): the loss within 1e-5 of |ref| and
  every gradient, gathered whole, within 1e-4 of its max|ref|
  (``_lm_parity``'s limits), and the gradient norm that ``global_norm``
  reads from the ranks' blocks (``shard_lm``'s groups, Mamba2's B and C
  weighted once by ``NormShare``) within 1e-5 of the reference
  gradients' norm, of the whole tree and of each Mamba2 ``in_proj`` and
  ``conv_w`` alone, whole and in its B and C runs.

Controls that must miss: the norms over the whole inner width computed
on each rank's channels alone (no all-reduce of the sum of squares;
zamba2 and xlstm served on (1, 4)), and the gradients of Mamba2's B and C
columns, whole on every rank, not summed over ``model`` (zamba2 trained
on (2, 2)), and the norm of B and C with ``NormShare``'s weight dropped
(counted on each ``model`` rank). Without ranks: ``blocks.Runs`` cuts and
joins every layout at the smoke and the full shapes, and a checkpoint of
a (1, 4) layout restores onto (2, 2).
"""

import contextlib
import dataclasses
import datetime
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
RUN_TIMEOUT = 300       # seconds; the ranks take about 20 s
WORLD = 4
TOL = 1e-5                                 # serving, of max
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4            # _lm_parity's LOSS_TOL, F32_TOL
NORM_TOL = 1e-5                            # the gradient norm, of |ref|
B, SEQ, NEW = 4, 8, 3
MAX_LEN = SEQ + NEW + 1                    # 3 positions a rank on (4, 1)
TRAIN_B, TRAIN_S, TRAIN_SEED, TRAIN_DM = 4, 16, 3, (2, 2)
ARCHS = ("zamba2_7b", "xlstm_1_3b", "qwen2_vl_7b", "musicgen_large")
MESHES = {"1x4": ((1, 4), B), "2x2": ((2, 2), B), "4x1": ((4, 1), 1)}
SERVE = [f"{a}_{m}" for a in ARCHS for m in MESHES]
CONTROLS = ("zamba2_7b_1x4", "xlstm_1_3b_1x4")


def _cfg(arch):
    from repro_torch import configs
    return dataclasses.replace(configs.get_smoke_config(arch),
                               compute_dtype="float32")


def _inputs(cfg):
    """The serving inputs: a prompt of SEQ positions and NEW one-token
    steps, tokens or (frontends) embeddings, with qwen2-vl's M-RoPE
    streams for the prompt (a 2 x 2 grid of patches, then text)."""
    rng = np.random.default_rng(7)
    if cfg.frontend:
        x = (0.02 * rng.standard_normal((B, SEQ + NEW, cfg.d_model))
             ).astype(np.float32)
        out = {"embeds": x[:, :SEQ]}
        steps = [{"embeds": x[:, i:i + 1]} for i in range(SEQ, SEQ + NEW)]
    else:
        x = rng.integers(0, cfg.vocab_size, (B, SEQ + NEW)).astype(np.int32)
        out = {"tokens": x[:, :SEQ]}
        steps = [{"tokens": x[:, i:i + 1]} for i in range(SEQ, SEQ + NEW)]
    if cfg.rope == "mrope":
        grid = 2
        t = np.arange(SEQ) - grid * grid + 1
        hw = np.stack(np.meshgrid(np.arange(grid), np.arange(grid),
                                  indexing="ij")).reshape(2, -1)
        pos = np.stack([np.maximum(t, 0)] * 3)
        pos[1:, :grid * grid] = hw
        out["positions"] = np.broadcast_to(
            pos[:, None], (3, B, SEQ)).astype(np.int32).copy()
    return out, steps


# ---------------------------------------------------------------------------
# the port's run (4 gloo ranks; no JAX)
# ---------------------------------------------------------------------------


def _tensors(batch, rows=slice(None)):
    import torch
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        t = t.long() if k in ("tokens", "labels") else t
        out[k] = t[:, rows] if k == "positions" else t[rows]
    return out


def _lm(cfg, weights):
    import torch
    from repro_torch.models import LM
    model = LM(cfg, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(weights[name]))
    return model


@contextlib.contextmanager
def float32_cache():
    """A prefill's cache in its k/v's dtype (float32 here), not
    bfloat16."""
    import torch
    from repro_torch.models import lm
    saved = lm._pad_seq
    lm._pad_seq = lambda t, pad: torch.cat(
        [t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1)
    try:
        yield
    finally:
        lm._pad_seq = saved


def _serve(model, step, prompt, steps, batch, rows, gather):
    """The logits of the prefill and of each decode step, gathered over
    the data ranks, as one (batch, 1 + NEW, V) array."""
    import torch
    with float32_cache():
        lg, cache = model.prefill(_tensors(prompt, rows), MAX_LEN,
                                  global_batch=batch)
        out = [gather(lg)]
        for one in steps:
            lg, cache = step(cache, _tensors(one, rows))
            out.append(gather(lg))
    return torch.cat(out, 1).numpy()


def _serve_case(name, weights):
    """(the mesh's logits, the one-device LM's (rank 0), the norm
    control's or None, whether ``Cell.build`` drew the placed blocks)."""
    import torch
    from unittest import mock
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import build_cell
    from repro_torch.models import LM, blocks
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.adamw import local
    from repro_torch.parallel import NamedSharding
    arch, mesh_name = name.rsplit("_", 1)
    dm, batch = MESHES[mesh_name]
    cfg = _cfg(arch)
    prompt, steps = _inputs(cfg)
    prompt = {k: v[:, :batch] if k == "positions" else v[:batch]
              for k, v in prompt.items()}
    steps = [{k: v[:batch] for k, v in s.items()} for s in steps]
    mesh = make_local_mesh(*dm)
    cell = build_cell(cfg, ShapeConfig("t", MAX_LEN, batch, "decode"), mesh)
    model = cell.place(_lm(cfg, weights))
    split = model.seq_split(batch)
    n = batch // dm[0]
    rows = slice(None) if split else slice(model.dp_rank * n,
                                           model.dp_rank * n + n)

    def gather(lg):
        if split:
            return lg
        return NamedSharding(mesh, ("data", None, None)).gather(lg)

    def step(cache, one):
        return cell.fn(model, cache, one)

    built = None
    if name == "zamba2_7b_1x4":
        # drawn a parameter at a time, each cut at once: the same blocks
        mine = dict(cell.build(torch.Generator().manual_seed(0))
                    .named_parameters())
        again = cell.place(LM(cfg, device="cpu"))
        built = all(torch.equal(local(mine[k]), local(p))
                    for k, p in again.named_parameters())
    got = _serve(model, step, prompt, steps, batch, rows, gather)
    control = None
    if name in CONTROLS:
        def per_rank(self, y):
            return y.float().square().sum(-1, keepdim=True) * self.size
        with mock.patch.object(blocks.TensorParallel, "sum_squares",
                               per_rank):
            control = _serve(model, step, prompt, steps, batch, rows,
                             gather)
    want = None
    if torch.distributed.get_rank() == 0:
        single = _lm(cfg, weights)
        want = _serve(single, single.decode_step, prompt, steps, batch,
                      slice(None), lambda lg: lg)
    torch.distributed.barrier()
    return got, want, control, built


def _train_case(arch, weights, tmp):
    """(loss, {name: whole gradient}, {name: norm}, {name: its layout's
    (dim, runs)}) of one (2, 2) Trainer step: the norms that
    ``global_norm`` reads from the ranks' blocks with the groups
    ``shard_lm`` gave, of the whole tree ("") and of each tensor with a
    ``NormShare`` alone, whole and in its whole runs ("name/whole runs";
    "name/unweighted": the same with the weight dropped)."""
    import torch
    from repro_torch.core.comm import make_mesh
    from repro_torch.models import loss_fn
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.adamw import NormShare, global_norm, local
    from repro_torch.runtime import Trainer, TrainerConfig
    cfg = _cfg(arch)
    tr = Trainer(cfg, ShapeConfig("t", TRAIN_S, TRAIN_B, "train"),
                 make_mesh(TRAIN_DM, ("data", "model")),
                 TrainerConfig(ckpt_dir=str(tmp), seed=TRAIN_SEED),
                 model=_lm(cfg, weights))
    model, _, _ = tr.init_state()
    loss, _ = loss_fn(model, tr.batch_at(0), tr.num_groups)
    loss.backward()
    # a frontend's embeds batch leaves the embedding table no gradient
    mine = {n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in model.named_parameters()}
    grads = {n: tr.shardings["params"][n].gather(g).numpy()
             for n, g in mine.items()}
    norms, runs = {"": float(global_norm(mine, tr.shard_groups))}, {}
    for n, share in tr.shard_groups.items():
        if isinstance(share, NormShare):
            whole = local(mine[n]) * (share.weight < 1)
            norms[n] = float(global_norm({n: mine[n]}, {n: share}))
            norms[f"{n}/whole runs"] = float(global_norm({n: whole},
                                                         {n: share}))
            norms[f"{n}/unweighted"] = float(global_norm(
                {n: whole}, {n: share.groups}))
            layout = tr.shardings["params"][n].layout
            runs[n] = (layout.dim, layout.runs)
    return float(loss), grads, norms, runs


def _port_rank(rank, store_path, in_path, out_path):
    import torch
    import torch.distributed as dist
    from unittest import mock
    torch.set_num_threads(1)
    from repro_torch.models import blocks
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    ref = np.load(in_path)
    tmp = Path(out_path).parent / f"ckpt{rank}"
    out, meta = {}, {}

    def weights(arch):
        return {k.split("/", 2)[2]: ref[k] for k in ref.files
                if k.startswith(f"{arch}/param/")}

    for name in SERVE:
        got, want, control, built = _serve_case(
            name, weights(name.rsplit("_", 1)[0]))
        out[f"{name}/got"] = got
        if want is not None:
            out[f"{name}/want"] = want
        if control is not None:
            out[f"{name}/control"] = control
        if built is not None:
            meta["build_equal"] = built
    for arch in ARCHS:
        loss, grads, norms, runs = _train_case(arch, weights(arch), tmp)
        meta[f"{arch}/loss"] = loss
        meta[f"{arch}/norms"], meta[f"{arch}/runs"] = norms, runs
        out.update({f"{arch}/grad/{k}": v for k, v in grads.items()})
    # the control: B and C's gradients left each rank's own
    with mock.patch.object(blocks.TensorParallel, "sync",
                           lambda self, w, layout: w):
        loss, grads, _, _ = _train_case("zamba2_7b", weights("zamba2_7b"),
                                        tmp)
    meta["control/loss"] = loss
    out.update({f"control/grad/{k}": v for k, v in grads.items()})
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
# the reference (the pytest process)
# ---------------------------------------------------------------------------


def _as_reference(flat, rc, abstract):
    """The port's parameters ``flat`` (numpy, by name) as the reference's
    tree, shaped as ``abstract`` (``init_params``' shapes): each segment's
    layers stacked on its leading axis (``convert.flatten_reference``
    undone)."""
    import jax
    import jax.numpy as jnp
    tree = {"embed": flat["embed"],
            "final_norm": {k: flat[f"final_norm.{k}"]
                           for k in abstract["final_norm"]}}
    if "lm_head" in abstract:
        tree["lm_head"] = flat["lm_head"]
    if "shared" in abstract:
        tree["shared"] = {part: {k: flat[f"shared.{part}.{k}"] for k in sub}
                          for part, sub in abstract["shared"].items()}
    tree["segments"], i = [], 0
    for seg, (_, count) in zip(abstract["segments"],
                               rc.resolved_segments()):
        tree["segments"].append({"layers": {
            part: {k: np.stack([flat[f"layers.{i + j}.{part}.{k}"]
                                for j in range(count)]) for k in sub}
            for part, sub in seg.get("layers", {}).items()}}
            if "layers" in seg else dict(seg))
        i += count
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _reference(tmp):
    """Each config's weights by the port's names (an LM drawn from seed 0),
    its prefill logits of the serving prompt, and its loss and gradients
    on the training batch with ``num_groups`` = 2."""
    import jax
    import jax.numpy as jnp
    from repro.data import SyntheticDataset as RData
    from repro.models import lm as rlm
    from repro.models.config import ShapeConfig as RShape
    from repro_torch.convert import flatten_reference
    from repro_torch.models import LM
    from _lm_parity import cfgs, to_np
    arrays, meta = {}, {}
    dp = TRAIN_DM[0]
    for arch in ARCHS:
        rc, pc = cfgs(arch, compute_dtype="float32")
        flat = {n: p.detach().numpy()
                for n, p in LM(pc, device="cpu").named_parameters()}
        params = _as_reference(flat, rc, jax.eval_shape(
            lambda k: rlm.init_params(rc, k), jax.random.key(0)))
        prompt, _ = _inputs(rc)
        batch = RData(rc, RShape("t", TRAIN_S, TRAIN_B, "train"),
                      seed=TRAIN_SEED).batch_at(0)

        def both(p, x, y):
            (loss, _), g = jax.value_and_grad(
                lambda p, x: rlm.loss_fn(p, rc, x, dp), has_aux=True)(p, x)
            lg, _ = rlm.prefill(p, rc, y, MAX_LEN)
            return loss, g, lg
        loss, grads, lg = jax.jit(both)(
            params, {k: jnp.asarray(v) for k, v in batch.items()},
            {k: jnp.asarray(v) for k, v in prompt.items()})
        meta[arch] = float(loss)
        arrays[f"{arch}/prefill"] = np.asarray(lg, np.float32)
        for k, v in flatten_reference(to_np(params), rc).items():
            arrays[f"{arch}/param/{k}"] = np.asarray(v, np.float32)
        for k, v in flatten_reference(to_np(grads), rc).items():
            arrays[f"{arch}/grad/{k}"] = np.asarray(v, np.float32)
    np.savez(tmp / "ref.npz", **arrays)
    return arrays, meta


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_kinds")
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


def _rel(got, want, vocab):
    got, want = got[..., :vocab], want[..., :vocab]
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", SERVE)
def test_mesh_prefill_matches_the_reference(runs, case):
    ref, _, ours, _ = runs
    arch, mesh_name = case.rsplit("_", 1)
    batch = MESHES[mesh_name][1]
    err = _rel(ours[f"{case}/got"][:, :1], ref[f"{arch}/prefill"][:batch],
               _cfg(arch).vocab_size)
    assert err <= TOL, err


@pytest.mark.parametrize("case", SERVE)
def test_mesh_prefill_and_decode_match_one_device(runs, case):
    _, _, ours, _ = runs
    err = _rel(ours[f"{case}/got"], ours[f"{case}/want"],
               _cfg(case.rsplit("_", 1)[0]).vocab_size)
    assert err <= TOL, err


@pytest.mark.parametrize("case", CONTROLS)
def test_a_norm_without_the_sum_of_squares_all_reduce_misses(runs, case):
    _, _, ours, _ = runs
    err = _rel(ours[f"{case}/control"], ours[f"{case}/want"],
               _cfg(case.rsplit("_", 1)[0]).vocab_size)
    assert err > 10 * TOL, err


def _misses(ours, ref, prefix, arch):
    out = []
    for k in ref:
        if k.startswith(f"{arch}/grad/"):
            name = k.split("/", 2)[2]
            got, want = ours[f"{prefix}/grad/{name}"], ref[k]
            assert got.shape == want.shape, (name, got.shape, want.shape)
            if np.abs(got - want).max() > GRAD_TOL * np.abs(want).max():
                out.append(name)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_a_2x2_step_matches_the_reference_loss_and_gradients(runs, arch):
    ref, ref_meta, ours, meta = runs
    want = ref_meta[arch]
    assert abs(meta[f"{arch}/loss"] - want) <= LOSS_TOL * abs(want)
    assert _misses(ours, ref, arch, arch) == []


def _ref_norm(ref, arch, name="", runs=None):
    """The norm of the reference's gradient ``name`` ("": of them all),
    or, with ``runs`` (a layout's dim and runs), of its whole runs."""
    if not name:
        return float(np.sqrt(sum(np.sum(np.square(v.astype(np.float64)))
                                 for k, v in ref.items()
                                 if k.startswith(f"{arch}/grad/"))))
    g = ref[f"{arch}/grad/{name}"].astype(np.float64)
    if runs is not None:
        dim, parts = runs
        keep = np.concatenate([np.full(n, not cut) for n, cut in parts])
        g = np.compress(keep, g, axis=dim)
    return float(np.sqrt(np.sum(np.square(g))))


@pytest.mark.parametrize("arch", ARCHS)
def test_a_2x2_step_matches_the_reference_gradient_norm(runs, arch):
    """``global_norm`` over the ranks' blocks, with the groups (and
    Mamba2's ``NormShare`` weights) that ``shard_lm`` returns, against the
    norm of the reference's gradients: of the whole tree, and of each
    tensor that holds whole runs inside its block (Mamba2's ``in_proj``
    and ``conv_w``), whole and in its whole runs (B and C) alone."""
    ref, _, _, meta = runs
    norms, layouts = meta[f"{arch}/norms"], meta[f"{arch}/runs"]
    assert bool(layouts) == (arch == "zamba2_7b"), layouts
    checks = [("", "", None)] + [
        (f"{n}{part}", n, layouts[n] if part else None)
        for n in layouts for part in ("", "/whole runs")]
    for key, name, only in checks:
        want = _ref_norm(ref, arch, name, only)
        assert abs(norms[key] - want) <= NORM_TOL * want, (
            key, norms[key], want)


def test_the_gradient_norm_without_the_normshare_weight_misses(runs):
    """Mamba2's B and C counted on every ``model`` rank (tp times): the
    norm of each tensor's whole runs comes out sqrt(tp) times too large."""
    ref, _, _, meta = runs
    norms, layouts = meta["zamba2_7b/norms"], meta["zamba2_7b/runs"]
    missed = {n: abs(norms[f"{n}/unweighted"] - want) / want
              for n in layouts
              for want in [_ref_norm(ref, "zamba2_7b", n, layouts[n])]}
    assert missed and min(missed.values()) > NORM_TOL, missed


def test_b_and_c_gradients_not_summed_over_model_miss(runs):
    ref, ref_meta, ours, meta = runs
    # the loss does not see it; the replicated columns' gradients do
    want = ref_meta["zamba2_7b"]
    assert abs(meta["control/loss"] - want) <= LOSS_TOL * abs(want)
    missed = _misses(ours, ref, "control", "zamba2_7b")
    assert missed and all(n.endswith(("in_proj", "conv_w"))
                          for n in missed), missed


def test_cell_build_draws_the_placed_recurrent_blocks(runs):
    assert runs[3]["build_equal"]


# ---------------------------------------------------------------------------
# the run layouts and checkpoints, without ranks
# ---------------------------------------------------------------------------


class _FakeMesh:
    """A (data, model) mesh as ``LM.place`` reads it, for one rank, with
    no process groups (placing runs no collective)."""

    def __init__(self, dm, rank):
        self.shape = {"data": dm[0], "model": dm[1]}
        self.coords = {"data": rank // dm[1], "model": rank % dm[1]}

    def get_group(self, axis):
        return None

    def get_local_rank(self, axis):
        return self.coords[axis]


def _placed(cfg, dm, rank):
    from repro_torch.models import LM
    from repro_torch.parallel import make_rules
    mesh = _FakeMesh(dm, rank)
    return LM(cfg, device="cpu").place(mesh, make_rules(mesh))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_runs_cut_and_join_every_layout(arch, full):
    """Every layout of a (1, 4) placement cuts a whole tensor into four
    blocks of the placed shape and joins them back; at the full shapes
    along the cut dim (the other dims 1), at the smoke shapes whole."""
    import torch
    from repro_torch import configs
    from repro_torch.models.lm import _flat, model_meta
    from repro_torch.models import LM
    from repro_torch.parallel import make_rules
    cfg = (configs.get_config(arch) if full else _cfg(arch))
    kinds = tuple(dict.fromkeys(k for k, _ in cfg.resolved_segments()))
    cfg = dataclasses.replace(cfg, num_layers=len(kinds),
                              segments=tuple((k, 1) for k in kinds))
    mesh = _FakeMesh((1, 4), 0)
    model = LM(cfg, device="meta").place(mesh, make_rules(mesh))
    layouts = model.tp_layouts()
    placed = {n: p.shape for n, p in model.named_parameters()}
    cut = 0
    for name, m in _flat(model_meta(cfg)).items():
        layout = layouts[name]
        if layout is None:
            assert placed[name] == m.shape, name
            continue
        cut += 1
        shape = [1] * len(m.shape) if full else list(m.shape)
        shape[layout.dim] = m.shape[layout.dim]
        whole = torch.arange(int(np.prod(shape)),
                             dtype=torch.float64).reshape(shape)
        parts = [layout.block(whole, 4, r) for r in range(4)]
        want = list(shape)
        want[layout.dim] = placed[name][layout.dim]
        assert all(list(p.shape) == want for p in parts), name
        assert torch.equal(layout.join(parts), whole), name
        if layout.mixed:
            # the whole runs on every rank, each counted once in a norm
            assert float(layout.weight(4).sum()) * 4 == m.shape[layout.dim]
    assert cut


@pytest.mark.parametrize("arch", ["zamba2_7b", "xlstm_1_3b"])
def test_a_1x4_checkpoint_restores_onto_2x2(arch, tmp_path):
    """The blocks of four (1, 4) ranks joined (the checkpoint's gather
    after its all-gather), written in the one-device format, restored by
    each (2, 2) rank's ``MeshLayout``: that rank's placed blocks."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime.trainer import MeshLayout
    cfg = _cfg(arch)
    ranks = [_placed(cfg, (1, 4), r) for r in range(4)]
    layouts = ranks[0].tp_layouts()
    blocks = [dict(m.named_parameters()) for m in ranks]
    whole = {n: (layouts[n].join([b[n] for b in blocks])
                 if layouts[n] is not None else blocks[0][n]).detach()
             for n in blocks[0]}
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, {"params": whole})
    ckpt.wait()
    for r in range(4):
        lm = _placed(cfg, (2, 2), r)
        like = {n: p.detach() for n, p in lm.named_parameters()}
        sh = {n: MeshLayout(p, lm.tp, lm.tp_layouts()[n])
              for n, p in like.items()}
        got, _ = ckpt.restore(1, {"params": like}, {"params": sh})
        for n, t in got["params"].items():
            assert torch.equal(t, like[n]), (r, n)


if __name__ == "__main__":
    {"port": port_main}[sys.argv[1]](*sys.argv[2:])
