"""The port's serving loop (repro_torch.launch.serve) against the
reference's (repro.launch.serve) on the CPU, and its device policy.

Both loops serve the same requests with the same weights (the reference
loop's, carried across by ``convert.lm_from_reference``) in float32; their
greedy tokens must be equal.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.launch import serve as rserve
from repro_torch import configs as pconfigs
from repro_torch.convert import lm_from_reference
from repro_torch.launch.serve import Request, ServeLoop
from repro_torch.models import LM

ROOT = Path(__file__).resolve().parents[1]
FFTCONV = dict(segments=(("fftconv_mlp", 2),))


def _requests(vocab, lengths, max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(r, rng.integers(0, vocab, n).astype(np.int32), m)
            for r, (n, m) in enumerate(zip(lengths, max_new))]


@pytest.mark.parametrize("arch,changes", [("olmo_1b", {}),
                                          ("olmo_1b", FFTCONV)])
def test_serve_loop_matches_reference(arch, changes):
    rc = dataclasses.replace(rconfigs.get_smoke_config(arch), **changes)
    pc = dataclasses.replace(pconfigs.get_smoke_config(arch), **changes)
    # more requests than slots, prompt lengths off the bucket of 8, and
    # budgets that free slots at different steps
    lengths, max_new = (5, 9, 3, 12, 7), (4, 2, 5, 1, 3)
    ref = rserve.ServeLoop(rc, batch=2, max_len=32)
    for req in _requests(rc.vocab_size, lengths, max_new):
        ref.submit(rserve.Request(req.rid, req.prompt, req.max_new))
    ref.drain()
    model = lm_from_reference(jax.tree_util.tree_map(np.asarray, ref.params),
                              pc, device="cpu")
    ours = ServeLoop(pc, batch=2, max_len=32, model=model)
    assert ours.prompt_bucket == ref.prompt_bucket
    for req in _requests(pc.vocab_size, lengths, max_new):
        ours.submit(req)
    ours.drain()
    assert [r.rid for r in ours.done] == [r.rid for r in ref.done]
    for a, b in zip(ours.done, ref.done):
        assert len(a.out) == a.max_new
        assert a.out == b.out, (a.rid, a.out, b.out)


def test_serve_loop_matches_greedy_forward():
    # as tests/test_serving.py does for the reference: each request's
    # tokens are the argmax of forward over its prompt and tokens so far
    cfg = pconfigs.get_smoke_config("olmo_1b")
    loop = ServeLoop(cfg, batch=2, max_len=64, device="cpu", seed=3)
    reqs = _requests(cfg.vocab_size, (5, 11, 8), (4, 4, 4), seed=1)
    for req in reqs:
        loop.submit(req)
    loop.drain()
    assert sorted(r.rid for r in loop.done) == [0, 1, 2]
    for req in reqs:
        toks = list(req.prompt)
        for _ in range(4):
            with torch.no_grad():
                lg, _ = loop.model({"tokens": torch.tensor([toks])})
            toks.append(int(torch.argmax(lg[0, -1])))
        assert req.out == toks[len(req.prompt):], req.rid


def test_serve_loop_takes_the_planner_and_hook():
    cfg = dataclasses.replace(pconfigs.get_smoke_config("olmo_1b"), **FFTCONV)
    from repro_torch import Planner
    planner = Planner(backends=("hopper",))
    model = LM(cfg, device="cpu")
    seen = []

    class Recorded(ServeLoop):
        def next_token(self, req, logits):
            seen.append((req.rid, logits.shape))
            return 7

    loop = Recorded(cfg, batch=2, max_len=16, model=model, planner=planner)
    assert model.planner is planner
    for req in _requests(cfg.vocab_size, (4, 6, 5), (3, 3, 3)):
        loop.submit(req)
    loop.drain()
    assert all(r.out == [7, 7, 7] for r in loop.done)
    assert len(seen) == 9 and all(s == (512,) for _, s in seen)


def test_device_none_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is the GPU")
    cfg = pconfigs.get_smoke_config("olmo_1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeLoop(cfg, batch=2, max_len=16)


def test_cli_serves_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "olmo-1b", "--smoke", "--device", "cpu", "--requests", "3",
         "--batch", "2", "--max-new", "4", "--max-len", "32"],
        env=env, check=True, capture_output=True, text=True, timeout=120)
    got = json.loads(out.stdout)
    assert got["requests"] == 3 and got["generated_tokens"] == 12
    assert got["device"] == "cpu" and got["tok_per_s"] > 0
