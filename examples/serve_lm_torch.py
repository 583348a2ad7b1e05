"""End-to-end serving on the PyTorch port: batched requests through the
continuous-batching decode loop (prefill + decode with per-architecture
state caches). The port of examples/serve_lm.py.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch olmo-1b \
        --requests 12 --device cpu

Without --device it runs on the GPU, and raises without one.
"""

import argparse
import time

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import Request, ServeLoop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    loop = ServeLoop(cfg, batch=args.batch, max_len=256, device=args.device)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for r in range(args.requests):
        loop.submit(Request(r, rng.integers(0, cfg.vocab_size,
                                            args.prompt_len).astype(np.int32),
                            max_new=args.max_new))
    loop.drain()
    dt = time.perf_counter() - t0
    total = sum(len(r.out) for r in loop.done)
    print(f"served {len(loop.done)} requests, {total} tokens "
          f"in {dt:.1f}s ({total / dt:.1f} tok/s, batch={args.batch}, "
          f"arch={cfg.name} [reduced], device={loop.device})")
    for r in loop.done[:3]:
        print(f"  req {r.rid}: {r.out[:8]}...")


if __name__ == "__main__":
    main()
