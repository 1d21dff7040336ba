"""Serve a small model with batched requests over HHZS-tiered paged KV, on
the PyTorch/CUDA port: prefill through the flash kernel, decode through
the paged kernel.

The port's twin of ``examples/serve_paged.py``: the same model config,
pool, requests and printed lines.  Deliberately undersizes the HBM pool so
the tier manager must demote / promote / prefix-cache sequences mid-flight
— the serving-side analogue of the paper's placement, migration, and
caching (DESIGN.md §Adaptation).  The weights are drawn on the CPU from
seed 0 and moved to the device, so every device serves the same model.

  PYTHONPATH=src python examples/serve_paged_torch.py                # card
  PYTHONPATH=src python examples/serve_paged_torch.py --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import init_model
from repro_torch.serving import Request, ServingEngine

N_REQUESTS = 12
POOLS = dict(hbm_zones=6, host_zones=64, pages_per_zone=2, page_size=8,
             max_batch=4, cache_zones=2)


def submit_requests(eng, vocab_size: int, n: int) -> None:
    """The example's requests, from one seeded generator: the first ``n``
    of them (each request's draws follow the ones before it)."""
    rng = np.random.default_rng(7)
    for i in range(n):
        plen = int(rng.integers(8, 24))
        eng.submit(Request(rid=i,
                           prompt=rng.integers(0, vocab_size,
                                               plen).astype(np.int32),
                           max_new_tokens=int(rng.integers(4, 10))))


def main(argv=None, model=None, requests: int = N_REQUESTS) -> dict:
    """Serve the example's first ``requests`` requests (all 12 by default)
    on ``model`` (default: ``init_model(cfg, seed=0)`` drawn on the CPU);
    return the lines printed, the engine's stats and each request's
    generated tokens by id."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the model and the device KV pool live (no "
                         "card: raises)")
    args = ap.parse_args(argv)
    lines = []

    def say(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    cfg = get_config("qwen3-1.7b").smoke()
    if model is None:
        model = init_model(cfg, seed=0, device="cpu")
    eng = ServingEngine(cfg, model, torch_device=args.device, **POOLS)
    submit_requests(eng, cfg.vocab_size, requests)
    t0 = time.time()
    stats = eng.run(max_steps=200)
    wall = time.time() - t0
    say(f"served {stats['done']}/{requests} requests, "
        f"{stats['tokens_out']} tokens in {stats['steps']} engine steps "
        f"({stats['tokens_out']/wall:.1f} tok/s wall)")
    say(f"KV placement: hbm={stats['hbm_placements']} "
        f"host={stats['host_placements']}")
    say(f"tiering: demotions={stats['demotions']} "
        f"promotions={stats['promotions']} "
        f"migrated={stats['bytes_migrated']/1e6:.2f}MB")
    say(f"prefix cache: admits={stats['cache_admits']} "
        f"hits={stats['cache_hits']}")
    if stats["done"] != requests:
        raise RuntimeError(f"served {stats['done']} of {requests} requests")
    return {"lines": lines, "stats": stats, "wall_s": wall,
            "tokens": {r.rid: list(r.out_tokens) for r in eng.done}}


if __name__ == "__main__":
    main()
