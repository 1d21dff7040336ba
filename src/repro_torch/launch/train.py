"""End-to-end training driver on one device.

Wires: config -> synthetic data (deterministic resume) -> the train step
on the device -> periodic checkpoints -> supervisor restart loop, as the
reference's ``launch/train.py``; with no mesh (the loop runs on one
card: ``model_parallel`` must be 1, and ``fsdp`` and
``seq_shard_activations`` change nothing on one device, as on the
reference's one-device mesh).  The meshes are ``launch/mesh.py``'s and
the parameter and state specs ``sharding.py``'s; the loop takes them
when it trains on DTensor state under ``sharding.state_specs``, the
next slice of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
      --steps 6 --batch 4 --seq 2048

Each batch is assembled on the host by ``Prefetcher`` in a thread, pinned
and copied to the card with ``non_blocking``; nothing is read back from
the device inside a step except at ``log_every``.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..checkpoint import ckpt
from ..config import ParallelConfig, TrainConfig
from ..configs import get_config
from ..data import Prefetcher, SyntheticLM
from ..ft import TrainSupervisor
from ..models import steps as S


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A host batch on ``device``: through pinned memory and a
    non-blocking copy for a CUDA device (the caching host allocator keeps
    a pinned block until the copy that reads it has run)."""
    if device.type != "cuda":
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    return {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
            for k, v in batch.items()}


def train_loop(cfg, *, steps: int, batch: int, seq: int,
               tc: Optional[TrainConfig] = None,
               parallel: Optional[ParallelConfig] = None,
               ckpt_dir: Optional[str] = None, save_every: int = 50,
               model_parallel: int = 1, log_every: int = 10,
               resume: bool = True, fail_at: Optional[int] = None,
               seed: int = 0, log=print, device="cuda") -> Dict:
    if model_parallel != 1:
        raise ValueError(f"model_parallel={model_parallel}: train_loop "
                         "runs on one device; training on DTensor state "
                         "under sharding.state_specs comes with the slice "
                         "after the mesh and sharding rules")
    tc = tc or TrainConfig(total_steps=steps)
    parallel = parallel or ParallelConfig(seq_shard_activations=False)
    device = torch.device(device)
    data = SyntheticLM(cfg.vocab_size, batch, seq, seed=seed)
    step_fn = S.make_train_step(cfg, tc, parallel)
    like = S.state_shapes(cfg)

    start_step = 0
    if ckpt_dir and resume and ckpt.latest_step(ckpt_dir) is not None:
        state, start_step = ckpt.restore(like, ckpt_dir, device=device)
        log(f"[train] resumed from step {start_step}")
    else:
        state = S.init_state(cfg, seed=tc.seed, device=device)

    losses: list = []
    holder = {"state": state, "fail_at": fail_at}

    def run_steps(frm: int, to: int) -> int:
        it = Prefetcher(data.iter_from(frm))
        try:
            for step in range(frm, to):
                if holder["fail_at"] is not None \
                        and step == holder["fail_at"]:
                    holder["fail_at"] = None     # inject exactly once
                    raise RuntimeError("injected failure")
                hb = to_device(next(it), device)
                holder["state"], metrics = step_fn(holder["state"], hb)
                if (step + 1) % log_every == 0 or step + 1 == to:
                    loss = float(metrics["loss"])
                    losses.append((step + 1, loss))
                    log(f"[train] step {step+1:5d} loss {loss:.4f} "
                        f"lr {float(metrics['lr']):.2e} "
                        f"gnorm {float(metrics['grad_norm']):.2f}")
        finally:
            it.close()
        return to

    def save(step: int) -> None:
        if ckpt_dir:
            ckpt.save(holder["state"], step, ckpt_dir)

    def restore() -> int:
        holder["state"] = None                  # free it before loading
        st, step = ckpt.restore(like, ckpt_dir, device=device)
        holder["state"] = st
        return step

    sup = TrainSupervisor(save_every=save_every)
    t0 = time.time()
    final = sup.run(total_steps=steps, start_step=start_step,
                    run_steps=run_steps, save=save,
                    restore=restore if ckpt_dir else (lambda: start_step))
    wall = time.time() - t0
    return {"final_step": final, "losses": losses, "wall_s": wall,
            "restarts": sup.restarts, "events": sup.events,
            "state": holder["state"]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    out = train_loop(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                     ckpt_dir=args.ckpt_dir,
                     model_parallel=args.model_parallel, device=args.device)
    first = out["losses"][0][1] if out["losses"] else float("nan")
    last = out["losses"][-1][1] if out["losses"] else float("nan")
    print(f"[train] done: {out['final_step']} steps in {out['wall_s']:.1f}s"
          f"  loss {first:.3f} -> {last:.3f}")


if __name__ == "__main__":
    main()
