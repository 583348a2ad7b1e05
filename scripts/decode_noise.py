#!/usr/bin/env python3
"""How far a float32 run of the LM's decode path can lie from the float32
forward without a fault, for each model that ``chip_smoke.py`` phase 16
serves, on the GPU.

    python3 scripts/decode_noise.py

run from the root of a checkout on a machine with a CUDA card. Each model
is built as phase 16 builds it (random bfloat16 weights from a seed) and
its float32 view (``chip_smoke.float32_view``) serves 2 prompts of 2048
tokens fed 16 random tokens each, batch 4, once with the decode cache as
the port keeps it (bfloat16) and once in float32 (``float32_cache``).
Every served row is held against forward in float32 over the prompt and
the tokens, plain and, for the bfloat16 cache, with its rows past the
prompt attending as a decode step does (to bfloat16 k/v through
``blocks.decode_attention``, which rounds the query and the attention
weights to the cache's dtype). The float32 forward's own jitter is the
same forward over one token more (float32 arithmetic in another order).
Prints the largest relative error (of the max logit) of each.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.calibrate import card_label  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LM  # noqa: E402

PROMPTS = 2


def decode_style(start):
    """For ``cs.patched("flash_attention", ...)``: attention whose query
    rows from ``start`` on attend as a decode step does, to the keys and
    values up to their own in bfloat16."""
    from repro_torch.models import blocks

    def wrap(flash):
        def attention(q, k, v, causal=True, block_kv=1024, q_offset=0):
            out = flash(q, k, v, causal, block_kv, q_offset)
            kc, vc = k.to(torch.bfloat16), v.to(torch.bfloat16)
            lens = torch.empty(q.shape[0], dtype=torch.long, device=q.device)
            for i in range(start, q.shape[1]):
                out[:, i:i + 1] = blocks.decode_attention(
                    q[:, i:i + 1], kc, vc, lens.fill_(i + 1))
            return out
        return attention
    return wrap


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_noise: no CUDA device", file=sys.stderr)
        return 1
    label = card_label()
    print(label)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s, n = cs.KIND_PROMPT, cs.KIND_NEW
    for name, depth in cs.KIND_MODELS:
        cfg = get_config(name)
        if depth is not None:
            cfg = dataclasses.replace(cfg, num_layers=depth)
        rng = np.random.default_rng(cs.SEED + 2)
        prompts = [rng.integers(0, cfg.vocab_size, s).astype(np.int32)
                   for _ in range(PROMPTS)]
        tokens = {r: [int(x) for x in rng.integers(0, cfg.vocab_size, n)]
                  for r in range(PROMPTS)}
        with torch.no_grad():
            model = LM(cfg, generator=torch.Generator(
                device="cuda").manual_seed(cs.SEED)).to_compute_dtype()
            twin = cs.float32_view(model)
            n_moe = sum(x.kind == "attn_moe" for x in model.layers)
            served = {}
            for cache32 in (False, True):
                log = []
                with cs.patched("moe_fwd", cs.moe_logged(log)):
                    served[cache32] = cs.serve(
                        twin, twin.cfg, prompts, forced=tokens, new=n,
                        routing=log, cache32=cache32)
            out = {}
            for rid in range(PROMPTS):
                seq = np.concatenate([prompts[rid], tokens[rid]])

                def forward(seq, cache32, style):
                    with contextlib.ExitStack() as stack:
                        if style:
                            stack.enter_context(cs.patched(
                                "flash_attention", decode_style(s)))
                        if n_moe:
                            routes = served[cache32]["routes"][rid]
                            e = torch.cat([a for a, _ in routes])
                            k = torch.cat([b for _, b in routes])
                            stack.enter_context(cs.patched(
                                "moe_fwd", cs.moe_forced(
                                    [(e[:, i], k[:, i])
                                     for i in range(n_moe)])))
                        return cs.forward_rows(twin, cs.as_batch(seq), s - 1,
                                               s - 1 + n)

                def err(a, b):
                    return max(cs.rel_err(cfg, x, y) for x, y in zip(a, b))
                longer = np.concatenate([seq, [0]])
                plain = forward(seq, True, False)
                style = forward(seq, False, True)
                for what, value in (
                        ("float32 cache against the forward",
                         err(served[True]["rows"][rid], plain)),
                        ("bfloat16 cache against the decode-style forward",
                         err(served[False]["rows"][rid], style)),
                        ("the forward's jitter, one token more",
                         err(plain, forward(longer, True, False))),
                        ("the decode-style forward's jitter",
                         err(style, forward(longer, False, True))),
                        ("decode-style against plain", err(style, plain))):
                    out[what] = max(out.get(what, 0.0), value)
            print(f"{name}: " + "; ".join(f"{what} {value:.3e}"
                                          for what, value in out.items())
                  + f" (err/max, {PROMPTS} prompts x {n} rows) [{label}]",
                  flush=True)
        del model, twin, served
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
