"""The port's prefill and decode on a (data, model) mesh of 4 gloo ranks
against the port's own LM on one device, and the one-device port against
the reference's ``prefill`` / ``decode_step`` with ``num_groups`` = 2.

The fixture runs this file as a script,

    python tests/test_torch_mesh_serve.py port OUT.json

which spawns 4 gloo ranks (``torch.multiprocessing``, a FileStore, one
thread each; they never import JAX). Each case builds the smoke config's
LM in float32 on every rank, places it by ``launch.specs.build_cell``'s
decode cell (tensor parallelism over ``model``, FSDP2 over ``data``
where it has more than one rank),
prefills this rank's rows of the batch (every row where the batch is
smaller than the data axis: the flash-decoding layout), decodes 3 forced
tokens through the cell's ``serve_step`` (``num_groups`` = dp), gathers
the logits over the data ranks and holds them, on rank 0, against the
same LM on one device with the same ``num_groups``: within 1e-5 of max
(float32 arithmetic in another order). Caches are kept in float32 for it
(a bfloat16 cache rounds k/v, whose last-bit differences would flip).

Cases: olmo-1b (attention), phi3.5-moe (experts over ``model``) and an
FFT-conv LM on (1, 4) and (2, 2) at batch 4; an FFT-conv + attention LM
and phi3.5-moe on (4, 1) at batch 1, the cache's positions split over the
data ranks. Controls that must miss: phi3.5-moe on (1, 4) with each
rank's experts combined without the sum over ``model``, the (4, 1) case
with each rank's attention partials merged without the rescale to the
global max. zamba2 (Mamba2 and the shared attention) on (1, 4), xlstm
(mLSTM and sLSTM) on (2, 2) and qwen2-vl (M-RoPE, text) on (4, 1) at
batch 1 are served too. ``init_cache`` on each placed LM allocates what
``cache_pspecs`` describes (the K/V heads a rank reads where ``model``
does not divide them; a Mamba2 convolution state of its heads' channels
and B and C, an sLSTM state of its heads), and so does ``prefill``;
``Cell.build`` draws each rank's blocks of the same weights without the
whole model. ``ServeLoop``
on (1, 4) and (2, 2) picks the one-device loop's tokens.
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

pytestmark = pytest.mark.slow

ROOT = Path(__file__).resolve().parents[1]
RUN_TIMEOUT = 300       # seconds; the ranks take about 20 s
WORLD = 4
TOL = 1e-5
SEQ, NEW = 8, 3

# name -> (arch, config changes, (data, model), batch, prompt length,
# cache length)
CASES = {
    "olmo_1x4": ("olmo_1b", {}, (1, 4), 4, SEQ, 12),
    "olmo_2x2": ("olmo_1b", {}, (2, 2), 4, SEQ, 12),
    "phi_1x4": ("phi35_moe_42b", {}, (1, 4), 4, SEQ, 12),
    "phi_2x2": ("phi35_moe_42b", {}, (2, 2), 4, SEQ, 12),
    "fftconv_1x4": ("olmo_1b", {"segments": (("fftconv_mlp", 2),)}, (1, 4),
                    4, SEQ, 12),
    "fftconv_2x2": ("olmo_1b", {"segments": (("fftconv_mlp", 2),)}, (2, 2),
                    4, SEQ, 12),
    # the flash-decoding layout: 3 positions a rank, the prompt on ranks 0
    # and 1, the decoded tokens on rank 2, nothing on rank 3
    "flash_4x1": ("olmo_1b", {"segments": (("fftconv_mlp", 1),
                                           ("attn_mlp", 1))}, (4, 1), 1,
                  5, 12),
    "flash_phi_4x1": ("phi35_moe_42b", {}, (4, 1), 1, 5, 12),
    # the recurrent kinds (their states by heads over model) and M-RoPE
    "zamba2_1x4": ("zamba2_7b", {}, (1, 4), 4, SEQ, 12),
    "xlstm_2x2": ("xlstm_1_3b", {}, (2, 2), 4, SEQ, 12),
    "qwen2_vl_4x1": ("qwen2_vl_7b", {}, (4, 1), 1, 5, 12),
}
SERVE = {"serve_1x4": (1, 4), "serve_2x2": (2, 2)}


# ---------------------------------------------------------------------------
# the port's run (4 gloo ranks; no JAX)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def float32_cache():
    """A prefill's cache in its k/v's dtype (float32 here), not bfloat16."""
    import torch
    from repro_torch.models import lm
    saved = lm._pad_seq
    lm._pad_seq = lambda t, pad: torch.cat(
        [t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1)
    try:
        yield
    finally:
        lm._pad_seq = saved


@contextlib.contextmanager
def patched(name, fn):
    from repro_torch.models import blocks
    saved = getattr(blocks, name)
    setattr(blocks, name, fn(saved))
    try:
        yield
    finally:
        setattr(blocks, name, saved)


def no_model_sum(moe_fwd):
    """The control: each rank's experts combined, never summed over
    model."""
    from unittest import mock
    from repro_torch.models import blocks

    def run(*args, **kwargs):
        with mock.patch.object(blocks.TensorParallel, "reduce",
                               lambda self, y, dtype: y):
            return moe_fwd(*args, **kwargs)
    return run


def no_rescale(_):
    """The control: each rank's attention partials summed as they are."""
    def combine(m, num, den, seq):
        both = seq.reduce(__import__("torch").cat([num, den], -1))
        return both[..., :-1] / both[..., -1:]
    return combine


def cfg_of(arch, changes):
    from repro_torch import configs
    return dataclasses.replace(configs.get_smoke_config(arch),
                               compute_dtype="float32", **changes)


def _inputs(cfg, batch, seq):
    import torch
    rng = np.random.default_rng(7)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size, (NEW, batch, 1)))
    return prompts, steps


def _serve(model, step, prompts, steps, max_len, groups, rows, gather):
    """(logits of the prefill and of each decode step, gathered over the
    data ranks, the prefill's cache's shapes)."""
    out = []
    lg, cache = model.prefill({"tokens": prompts[rows]}, max_len, groups,
                              global_batch=len(prompts))
    shapes = {f"{i}.{k}": list(t.shape) for i, c in enumerate(cache["layers"])
              for k, t in c.items()}
    out.append(gather(lg))
    for tok in steps:
        lg, cache = step(cache, {"tokens": tok[rows]})
        out.append(gather(lg))
    return out, shapes


def _case(name, rank, tmp):
    import torch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import (build_cell, cache_abstract,
                                          cache_pspecs)
    from repro_torch.models import LM, blocks
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.adamw import local
    from repro_torch.parallel import NamedSharding, sanitized_shardings
    arch, changes, dm, batch, seq, max_len = CASES[name]
    cfg = cfg_of(arch, changes)
    mesh = make_local_mesh(*dm)
    cell = build_cell(cfg, ShapeConfig("t", max_len, batch, "decode"), mesh)
    model = cell.place(LM(cfg, device="cpu"))
    # an allocation of another batch's layout changes no later call
    model.init_cache(1, max_len)
    dp = dm[0]
    prompts, steps = _inputs(cfg, batch, seq)
    split = model.seq_split(batch)
    n = batch // dp
    rows = slice(None) if split else slice(model.dp_rank * n,
                                           model.dp_rank * n + n)

    def gather(lg):
        if split:
            return lg
        return NamedSharding(mesh, ("data", None, None)).gather(lg)

    def step(cache, tok):
        return cell.fn(model, cache, tok)

    res = {}
    if name in ("phi_1x4", "fftconv_2x2"):
        # a rank's blocks drawn one parameter at a time, never whole (before
        # a forward: FSDP2 leaves the root's parameters gathered after one)
        built = dict(cell.build(torch.Generator().manual_seed(0))
                     .named_parameters())
        res["build_equal"] = all(torch.equal(local(built[n]), local(p))
                                 for n, p in model.named_parameters())
    with float32_cache():
        got, shapes = _serve(model, step, prompts, steps, max_len, dp, rows,
                             gather)
        if name == "phi_1x4":
            with patched("moe_fwd", no_model_sum):
                res["control"] = _serve(model, step, prompts, steps,
                                        max_len, dp, rows, gather)[0]
        if name == "flash_4x1":
            with patched("lse_combine", no_rescale):
                res["control"] = _serve(model, step, prompts, steps,
                                        max_len, dp, rows, gather)[0]
    cache = model.init_cache(batch, max_len)
    res["init_cache"] = {
        f"{i}.{k}": list(t.shape) for i, c in enumerate(cache["layers"])
        for k, t in c.items()}
    res["init_cache"]["len"] = list(cache["len"].shape)
    res["prefill_cache"] = shapes
    specs = sanitized_shardings(mesh, cache_abstract(cfg, batch, max_len),
                                cache_pspecs(cfg, batch, mesh, cell.rules))
    whole = cache_abstract(cfg, batch, max_len)
    res["pspecs"] = {f"{i}.{k}": list(specs["layers"][i][k].shard(t).shape)
                     for i, c in enumerate(whole["layers"])
                     for k, t in c.items()}
    res["pspecs"]["len"] = list(specs["len"].shard(whole["len"]).shape)
    res["read_heads"] = [blocks.cached_kv_heads(layer.attn, cfg, layer.tp)
                         for layer in model.layers if hasattr(layer, "attn")]
    res["got"] = got
    if rank == 0:
        single = LM(cfg, device="cpu")
        with float32_cache():
            res["want"], _ = _serve(
                single, lambda c, t: single.decode_step(c, t, dp), prompts,
                steps, max_len, dp, slice(None), lambda lg: lg)
    torch.distributed.barrier()
    return res


def _serve_loop(name, rank):
    import torch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import Request, ServeLoop
    cfg = cfg_of("olmo_1b", {})
    mesh = make_local_mesh(*SERVE[name])
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, 5 + i % 3).astype(np.int32)
               for i in range(6)]

    def run(**kw):
        loop = ServeLoop(cfg, 4, 24, device="cpu", **kw)
        for rid, p in enumerate(prompts):
            loop.submit(Request(rid, p, 4))
        loop.drain()
        return {r.rid: r.out for r in loop.done}

    got = run(mesh=mesh)
    want = run() if rank == 0 else None
    torch.distributed.barrier()
    return {"got": got, "want": want}


def _port_rank(rank, store_path, out_path):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    out = {}
    for name in CASES:
        res = _case(name, rank, Path(out_path).parent)
        if rank == 0:
            want = res.pop("want")

            def worst(got):
                return max(float((g - w).abs().max() / w.abs().max())
                           for g, w in zip(got, want))
            res["err"] = worst(res.pop("got"))
            if "control" in res:
                res["control"] = worst(res["control"])
            out[name] = res
    for name in SERVE:
        res = _serve_loop(name, rank)
        if rank == 0:
            out[name] = res
    if rank == 0:
        Path(out_path).write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def port_main(out_path):
    import torch.multiprocessing as mp
    store = os.path.join(os.path.dirname(os.path.abspath(out_path)),
                         "gloo_store")
    mp.start_processes(_port_rank, args=(store, out_path), nprocs=WORLD,
                       start_method="spawn")


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_serve")
    proc = subprocess.run(
        [sys.executable, __file__, "port", str(tmp / "port.json")],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=RUN_TIMEOUT)
    assert proc.returncode == 0, proc.stdout
    return json.loads((tmp / "port.json").read_text())


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_prefill_and_decode_match_one_device(runs, case):
    assert runs[case]["err"] <= TOL, runs[case]["err"]


@pytest.mark.parametrize("case", ["phi_1x4", "flash_4x1"])
def test_mesh_serving_controls_miss(runs, case):
    # phi_1x4: no sum over model; flash_4x1: the partials not rescaled
    assert runs[case]["control"] > 100 * TOL, runs[case]["control"]


@pytest.mark.parametrize("case", list(CASES))
def test_init_cache_allocates_what_cache_pspecs_describes(runs, case):
    r = runs[case]
    arch, changes, dm, *_ = CASES[case]
    cfg = cfg_of(arch, changes)
    want = dict(r["pspecs"])
    heads = iter(r["read_heads"])
    for i, (kind, _) in enumerate(
            (k, None) for k, n in cfg.resolved_segments() for _ in range(n)):
        if kind in ("attn_mlp", "attn_moe", "shared_attn") and \
                cfg.num_kv_heads % dm[1]:
            # the K/V heads this rank's query heads read, whole
            h = next(heads)
            for key in ("k", "v"):
                want[f"{i}.{key}"] = want[f"{i}.{key}"][:2] + [h, cfg.hd]
        elif kind in ("attn_mlp", "attn_moe", "shared_attn"):
            next(heads)
        elif kind == "mamba2" and dm[1] > 1:
            # its heads' channels and B and C whole (the spec cuts the
            # concatenation)
            di, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
            want[f"{i}.conv"] = want[f"{i}.conv"][:2] + [di // dm[1] + 2 * n]
        elif kind == "slstm" and dm[1] > 1:
            # its heads, each whole (the spec cuts the head dim)
            for key in "cnhm":
                want[f"{i}.{key}"] = want[f"{i}.{key}"][:1] + [
                    cfg.slstm_heads // dm[1], cfg.d_model // cfg.slstm_heads]
    assert r["init_cache"] == want
    assert r["prefill_cache"] == {k: v for k, v in want.items()
                                  if k != "len"}


@pytest.mark.parametrize("case", ["phi_1x4", "fftconv_2x2"])
def test_cell_build_holds_the_placed_blocks_of_the_whole_lm(runs, case):
    assert runs[case]["build_equal"]


@pytest.mark.parametrize("case", list(SERVE))
def test_serve_loop_on_a_mesh_picks_the_one_device_tokens(runs, case):
    assert runs[case]["got"] == runs[case]["want"]


def test_one_device_port_matches_the_reference_with_two_groups():
    """phi3.5-moe smoke, batch 4: the port's ``prefill`` and
    ``decode_step`` with ``num_groups`` = 2 against the reference's
    (``_lm_parity``'s float32 tolerance), caches in bfloat16 on both
    sides."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.models import lm as rlm
    from repro_torch.convert import lm_from_reference
    from _lm_parity import F32_TOL, cfgs, to_np
    rc, pc = cfgs("phi35_moe_42b", compute_dtype="float32")
    params = rlm.init_params(rc, jax.random.key(0))
    model = lm_from_reference(to_np(params), pc, device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, pc.vocab_size, (4, SEQ + NEW))
    max_len = SEQ + NEW
    want, cache = jax.jit(lambda p, b: rlm.prefill(p, rc, b, max_len, 2))(
        params, {"tokens": jnp.asarray(toks[:, :SEQ])})
    got, pcache = model.prefill({"tokens": torch.from_numpy(toks[:, :SEQ])},
                                max_len, 2)
    errs = [float(np.abs(got.numpy() - np.asarray(want)).max()
                  / np.abs(np.asarray(want)).max())]
    step = jax.jit(lambda p, c, b: rlm.decode_step(p, rc, c, b, 2))
    for i in range(SEQ, SEQ + NEW - 1):
        want, cache = step(params, cache,
                           {"tokens": jnp.asarray(toks[:, i:i + 1])})
        got, pcache = model.decode_step(
            pcache, {"tokens": torch.from_numpy(toks[:, i:i + 1])}, 2)
        errs.append(float(np.abs(got.numpy() - np.asarray(want)).max()
                          / np.abs(np.asarray(want)).max()))
    assert max(errs) <= F32_TOL, errs


if __name__ == "__main__":
    {"port": port_main}[sys.argv[1]](*sys.argv[2:])
