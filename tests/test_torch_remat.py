"""The ``"dots"`` remat policy (the reference's
``dots_with_no_batch_dims_saveable``) against ``"full"``, and the
channel-parallel decode step of the FFT-conv mixer.

``"dots"`` must give the loss and every gradient of ``"full"`` (float32,
within 1e-6 of each tensor's max) and must save the weight products:
fewer ``aten.mm`` calls in the backward pass (counted with a
``TorchDispatchMode``), since the recompute skips them.

The mixer's decode: an FFT-conv LM placed on a (1, 2) gloo mesh (two
ranks spawned from a script run of this file, ``python
tests/test_torch_remat.py tp OUT.json``) prefills and decodes 3 tokens,
each rank holding half the channels, against the same LM on one device
within 1e-5 of max.
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
import torch

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-6
TP_TOL = 1e-5


def _cfg(segments):
    from repro_torch import configs
    return dataclasses.replace(configs.get_smoke_config("olmo_1b"),
                               compute_dtype="float32", segments=segments,
                               num_layers=sum(n for _, n in segments))


def _batch(cfg):
    rng = np.random.default_rng(11)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    return {"tokens": toks, "labels": toks}


def _loss_and_grads(cfg, policy, count=None):
    from repro_torch.models import LM, loss_fn
    model = LM(dataclasses.replace(cfg, remat_policy=policy), device="cpu")
    loss, _ = loss_fn(model, _batch(cfg))
    if count is None:
        loss.backward()
    else:
        with count:
            loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


SEGMENTS = {"attn_mlp": (("attn_mlp", 2),),
            "fftconv_mlp": (("fftconv_mlp", 1), ("attn_mlp", 1))}


@pytest.mark.parametrize("name", list(SEGMENTS))
def test_dots_gives_the_loss_and_gradients_of_full(name):
    cfg = _cfg(SEGMENTS[name])
    loss, grads = _loss_and_grads(cfg, "full")
    dots_loss, dots = _loss_and_grads(cfg, "dots")
    assert abs(dots_loss - loss) <= TOL * abs(loss)
    for n, g in grads.items():
        assert (dots[n] - g).abs().max() <= TOL * g.abs().max(), n


def test_dots_saves_the_weight_products():
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default):
                self.mm += 1
            return func(*args, **(kwargs or {}))

    cfg = _cfg(SEGMENTS["attn_mlp"])
    counts = {}
    for policy in ("full", "dots"):
        count = Count()
        _loss_and_grads(cfg, policy, count)
        counts[policy] = count.mm
    # full recomputes the layer's weight products in the backward up to the
    # last one whose output the backward reads (q, k, v, o, up, gate: the
    # non-reentrant recompute stops before the down projection); dots
    # reads them back
    assert counts["dots"] <= counts["full"] - 6 * cfg.num_layers, counts


# ---------------------------------------------------------------------------
# the FFT-conv mixer's decode, channel-parallel over (1, 2)
# ---------------------------------------------------------------------------

TP_CFG = (("fftconv_mlp", 2),)


def _serve(model, toks, max_len):
    lg, cache = model.prefill({"tokens": toks[:, :8]}, max_len)
    out = [lg]
    for i in range(8, 11):
        lg, cache = model.decode_step(cache, {"tokens": toks[:, i:i + 1]})
        out.append(lg)
    return torch.stack(out)


def _tp_rank(rank, store_path, out_path):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import LM
    from repro_torch.parallel import make_rules
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    cfg = _cfg(TP_CFG)
    toks = _batch(cfg)["tokens"]
    mesh = make_local_mesh(1, 2)
    model = LM(cfg, device="cpu").place(mesh, make_rules(mesh))
    got = _serve(model, toks, 12)
    if rank == 0:
        want = _serve(LM(cfg, device="cpu"), toks, 12)
        err = float((got - want).abs().max() / want.abs().max())
        Path(out_path).write_text(json.dumps(
            {"err": err, "hist": list(model.init_cache(2, 12)["layers"][0]
                                      ["v_hist"].shape)}))
    dist.barrier()
    dist.destroy_process_group()


def tp_main(out_path):
    import torch.multiprocessing as mp
    store = os.path.join(os.path.dirname(os.path.abspath(out_path)),
                         "gloo_store")
    mp.start_processes(_tp_rank, args=(store, out_path), nprocs=2,
                       start_method="spawn")


def test_channel_parallel_fftconv_decode_matches_one_device(tmp_path):
    proc = subprocess.run(
        [sys.executable, __file__, "tp", str(tmp_path / "tp.json")],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stdout
    got = json.loads((tmp_path / "tp.json").read_text())
    assert got["hist"] == [2, 12, _cfg(TP_CFG).d_model // 2]
    assert got["err"] <= TP_TOL, got["err"]


if __name__ == "__main__":
    {"tp": tp_main}[sys.argv[1]](*sys.argv[2:])
