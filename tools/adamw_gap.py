#!/usr/bin/env python3
"""Where AdamW on the card and on the CPU part, element by element.

    python3 tools/adamw_gap.py [--seq 256,128]

``chip_smoke.py`` phase 13 holds ``adamw.update`` on the card against the
same update on the CPU, on one state and one set of gradients: Hymba-1.5B
cut to 3 layers (fp32 from ``init_state(seed=0)``) and the gradients of
one CPU step on a SyntheticLM batch of 2 x ``--seq`` tokens.  Its check
allows masters within 1e-4 of each tensor's largest and bf16 parameters
within one bf16 step of each other.

For each ``--seq`` this tool runs that update on both devices and prints
one JSON line: the masters' largest gap relative to each tensor's
largest, the elements whose bf16 parameters lie more than one step
apart, and for the element farthest apart its leaf, index, both masters
and bf16 parameters, the bf16 step at its magnitude, the tensor's
largest master, and the same update evaluated in fp64 on the CPU (its
master, that master rounded to bf16, and the device whose master lies
nearer to it).  Needs a CUDA card; prints the card's name and power
limit first.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def fp64_master(base: dict, grads: dict, name: str, tc) -> torch.Tensor:
    """``adamw.update``'s new master of leaf ``name``, in fp64 on the
    CPU."""
    opt = base["opt"]
    gnorm = math.sqrt(sum(float(g.double().square().sum())
                          for g in grads.values()))
    scale = min(tc.grad_clip / (gnorm + 1e-9), 1.0)
    step = float(opt.step) + 1
    warm = min(step / max(tc.warmup_steps, 1), 1.0)
    prog = min(max((step - tc.warmup_steps)
                   / max(tc.total_steps - tc.warmup_steps, 1), 0.0), 1.0)
    lr = tc.learning_rate * warm * 0.5 * (1 + math.cos(math.pi * prog))
    b1, b2 = tc.beta1, tc.beta2
    g = grads[name].double() * scale
    m = b1 * opt.mu[name].double() + (1 - b1) * g
    v = b2 * opt.nu[name].double() + (1 - b2) * g * g
    p = opt.master[name].double()
    mhat, vhat = m / (1 - b1 ** step), v / (1 - b2 ** step)
    return p - lr * (mhat / (vhat.sqrt() + 1e-8) + tc.weight_decay * p)


def bf16_step_at(x: float) -> float:
    """The spacing of bf16 numbers at |x| (its smallest step at 0)."""
    if x == 0.0:
        return 2.0 ** -133
    return 2.0 ** (max(math.frexp(abs(x))[1], -125) - 8)


def gap(seq: int) -> dict:
    name, layers, _ = cs.TRAIN_IDENTITY[-1]
    cfg = dataclasses.replace(cs.get_config(name), num_layers=layers)
    base = cs.init_state(cfg, seed=0, device="cpu", dtype=torch.float32)
    batch = cs.SyntheticLM(cfg.vocab_size, cs.TRAIN_BATCH, seq,
                           seed=13).batch_at(0)
    cpu, _ = cs.train_run(cfg, base, batch, 1, "cpu", False)
    grads = {n: t / (1 - cs.TRAIN_TC.beta1) for n, t in cpu["mu"].items()}
    side = {}
    for dev in ("cuda", "cpu"):
        st = cs.state_to(base, dev)
        params, opt, _ = cs.adamw.update(
            {n: g.to(dev) for n, g in grads.items()}, st["opt"], cs.TRAIN_TC)
        side[dev] = ({n: t.cpu() for n, t in params.items()},
                     {n: t.cpu() for n, t in opt.master.items()})
    (pc, mc), (pp, mp) = side["cuda"], side["cpu"]
    steps = {n: (cs.bf16_line(pc[n]) - cs.bf16_line(pp[n])).abs()
             for n in grads}
    leaf = max(steps, key=lambda n: int(steps[n].max()))
    i = int(steps[leaf].flatten().argmax())
    exact = fp64_master(base, grads, leaf, cs.TRAIN_TC).flatten()[i]
    at = {"card": float(mc[leaf].flatten()[i]),
          "cpu": float(mp[leaf].flatten()[i])}
    return {
        "model": name, "layers": layers, "batch": [cs.TRAIN_BATCH, seq],
        "masters_rel_err": max(cs.rel_err(mc[n], mp[n]) for n in grads),
        "elements_over_one_step": int(sum(int((s > 1).sum())
                                          for s in steps.values())),
        "worst": {
            "leaf": leaf, "index": list(
                map(int, torch.unravel_index(torch.tensor(i),
                                             pc[leaf].shape))),
            "bf16_steps": int(steps[leaf].max()),
            "master": at, "master_fp64": float(exact),
            "param_bf16": {"card": float(pc[leaf].flatten()[i]),
                           "cpu": float(pp[leaf].flatten()[i]),
                           "fp64": float(exact.to(torch.bfloat16))},
            "bf16_step_there": bf16_step_at(at["cpu"]),
            "masters_gap": abs(at["card"] - at["cpu"]),
            "leaf_largest_master": float(mp[leaf].abs().max()),
            "nearer_fp64": min(at, key=lambda d: abs(at[d] - float(exact)))
            if at["card"] != at["cpu"] else "equal"}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", default=str(cs.TRAIN_IDENTITY[-1][2]),
                    help="comma-separated tokens a sequence")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("adamw_gap: no CUDA card visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    for seq in map(int, args.seq.split(",")):
        print(json.dumps(gap(seq)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
