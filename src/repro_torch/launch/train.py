"""End-to-end training driver, on one device or on DTensor state across
the ranks of a process group.

Wires: config -> synthetic data (deterministic resume) -> the train step
-> periodic checkpoints -> supervisor restart loop, as the reference's
``launch/train.py``.  With no process group the loop runs on one device
(``model_parallel`` must be 1; ``fsdp`` and ``seq_shard_activations``
change nothing there, as on the reference's one-device mesh).  With a
group initialised (``torch.distributed.init_process_group``: NCCL for
CUDA devices, gloo for the CPU) it trains on the group's
``make_local_mesh(model_parallel)``: the state is initialised, or
restored, under ``sharding.state_specs``, each batch is placed under the
reference's ``batch_specs`` (tokens and targets sharded over the data
axes), the step runs on DTensor state (``models.steps``), and rank 0
writes the checkpoints, in the reference's layout whatever the mesh.
``model_parallel > 1`` without a group raises: the loop never falls back
to one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
      --steps 6 --batch 4 --seq 2048
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen3-1.7b --smoke --model-parallel 2 --device cpu

Each batch is assembled on the host by ``Prefetcher`` in a thread, pinned
and copied to the card with ``non_blocking``; nothing is read back from
the device inside a step except at ``log_every``.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

from .. import sharding as SH
from ..checkpoint import ckpt
from ..config import ParallelConfig, TrainConfig
from ..configs import get_config
from ..data import Prefetcher, SyntheticLM
from ..ft import TrainSupervisor
from ..models import steps as S
from .mesh import make_local_mesh


def to_device(batch: Dict[str, np.ndarray], device: torch.device,
              mesh=None) -> Dict[str, torch.Tensor]:
    """A host batch on ``device``: through pinned memory and a
    non-blocking copy for a CUDA device (the caching host allocator keeps
    a pinned block until the copy that reads it has run).  With ``mesh``,
    each array becomes a DTensor sharded over ``data_axes(mesh)`` on its
    first dim, as the reference's ``b_shard`` places tokens and targets;
    every rank holds the same host batch, so each keeps its block with no
    exchange."""
    if device.type != "cuda":
        out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    else:
        out = {k: torch.from_numpy(v).pin_memory().to(device,
                                                      non_blocking=True)
               for k, v in batch.items()}
    if mesh is None:
        return out
    pl = SH.placements(mesh, SH.P(SH.data_axes(mesh), None))
    return {k: distribute_tensor(v, mesh, pl, src_data_rank=None)
            for k, v in out.items()}


def group_initialised() -> bool:
    return dist.is_available() and dist.is_initialized()


def train_loop(cfg, *, steps: int, batch: int, seq: int,
               tc: Optional[TrainConfig] = None,
               parallel: Optional[ParallelConfig] = None,
               ckpt_dir: Optional[str] = None, save_every: int = 50,
               model_parallel: int = 1, log_every: int = 10,
               resume: bool = True, fail_at: Optional[int] = None,
               seed: int = 0, log=print, device="cuda") -> Dict:
    """Train ``steps`` steps (see the module's docstring): on one device
    with no process group, on DTensor state over the group's
    ``make_local_mesh(model_parallel)`` with one.  Returns the final
    step, the logged (step, loss) pairs, the wall time, the supervisor's
    restarts and events, and the state; ``metrics`` beside ``losses``
    holds every logged step's loss, grad norm and lr."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"train_loop(device={str(device)!r}): no CUDA "
                           "card visible; pass device='cpu' to train on the "
                           "CPU")
    if not group_initialised() and model_parallel != 1:
        raise RuntimeError(
            f"model_parallel={model_parallel} needs a process group: call "
            "torch.distributed.init_process_group (NCCL for CUDA devices, "
            "gloo for the CPU) before train_loop; it never falls back to "
            "one device")
    tc = tc or TrainConfig(total_steps=steps)
    parallel = parallel or ParallelConfig(seq_shard_activations=False)
    data = SyntheticLM(cfg.vocab_size, batch, seq, seed=seed)
    like = S.state_shapes(cfg)
    mesh = shardings = constraint = None
    if group_initialised():
        mesh = make_local_mesh(model_parallel, device.type)
        shardings = (mesh, SH.state_specs(mesh, cfg, like,
                                          fsdp=parallel.fsdp))
        constraint = SH.activation_constraint(
            mesh, seq_shard=parallel.seq_shard_activations)
    step_fn = S.make_train_step(cfg, tc, parallel, constraint)

    start_step = 0
    if ckpt_dir and resume and ckpt.latest_step(ckpt_dir) is not None:
        state, start_step = ckpt.restore(like, ckpt_dir, device=device,
                                         shardings=shardings)
        log(f"[train] resumed from step {start_step}")
    else:
        state = S.init_state(cfg, seed=tc.seed, device=device,
                             shardings=shardings)

    losses: list = []
    logged: list = []
    holder = {"state": state, "fail_at": fail_at}

    def run_steps(frm: int, to: int) -> int:
        it = Prefetcher(data.iter_from(frm))
        try:
            for step in range(frm, to):
                if holder["fail_at"] is not None \
                        and step == holder["fail_at"]:
                    holder["fail_at"] = None     # inject exactly once
                    raise RuntimeError("injected failure")
                hb = to_device(next(it), device, mesh)
                holder["state"], metrics = step_fn(holder["state"], hb)
                if (step + 1) % log_every == 0 or step + 1 == to:
                    loss = float(metrics["loss"])
                    losses.append((step + 1, loss))
                    logged.append((step + 1, {k: float(v) for k, v in
                                              metrics.items()}))
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
        st, step = ckpt.restore(like, ckpt_dir, device=device,
                                shardings=shardings)
        holder["state"] = st
        return step

    sup = TrainSupervisor(save_every=save_every)
    t0 = time.time()
    final = sup.run(total_steps=steps, start_step=start_step,
                    run_steps=run_steps, save=save,
                    restore=restore if ckpt_dir else (lambda: start_step))
    wall = time.time() - t0
    return {"final_step": final, "losses": losses, "metrics": logged,
            "wall_s": wall, "restarts": sup.restarts, "events": sup.events,
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
    if "WORLD_SIZE" in os.environ:      # started by torchrun
        dist.init_process_group(
            "nccl" if torch.device(args.device).type == "cuda" else "gloo")
        if torch.device(args.device).type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
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
    if group_initialised():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
