"""The port's serving loop (repro_torch.launch.serve) against the
reference's (repro.launch.serve) on the CPU for the layer kinds beside
attn_mlp and fftconv_mlp: zamba2 (Mamba2 and the shared attention block),
xlstm (mLSTM, sLSTM) and phi3.5-moe (MoE) at their smoke configs.

Both loops serve the same requests with the same weights (the reference
loop's, carried across by ``convert.lm_from_reference``) in float32; their
greedy tokens must be equal. A MoE layer's capacity counts the whole
decode batch, empty slots included, so these tokens also hold the port to
the reference's slot schedule.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro import configs as rconfigs
from repro.launch import serve as rserve
from repro_torch import configs as pconfigs
from repro_torch.convert import lm_from_reference
from repro_torch.launch.serve import Request, ServeLoop

ROOT = Path(__file__).resolve().parents[1]


def _requests(vocab, lengths, max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(r, rng.integers(0, vocab, n).astype(np.int32), m)
            for r, (n, m) in enumerate(zip(lengths, max_new))]


@pytest.mark.parametrize("arch", ["zamba2_7b", "xlstm_1_3b",
                                  "phi35_moe_42b"])
def test_serve_loop_matches_reference(arch):
    rc = rconfigs.get_smoke_config(arch)
    pc = pconfigs.get_smoke_config(arch)
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


@pytest.mark.parametrize("arch", ["zamba2-7b", "qwen2-vl-7b"])
def test_cli_serves_the_new_kinds_on_the_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--requests", "3", "--batch", "2",
         "--max-new", "4", "--max-len", "32"],
        env=env, check=True, capture_output=True, text=True, timeout=120)
    got = json.loads(out.stdout)
    assert got["requests"] == 3 and got["generated_tokens"] == 12
    assert got["device"] == "cpu" and got["tok_per_s"] > 0
