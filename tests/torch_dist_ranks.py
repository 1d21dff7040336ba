"""Ranks of a gloo process group on the CPU, for the port's multi-device
tests (``tests/test_torch_sharding.py``, ``tests/test_torch_moe_sharded.py``,
``tests/test_torch_train_sharded.py``).

    python tests/torch_dist_ranks.py JOB RANK WORLD DIR

Each rank joins a group through a ``FileStore`` in DIR (no port is
bound), runs one thread, reads its inputs from DIR/inputs.npz, runs JOB
and writes what it found to DIR/out<RANK>.pt.  ``run_ranks`` starts the
ranks and waits for them with a time limit.  Imports torch and the port,
never jax or ``repro``.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "src"


def run_ranks(runs: list, timeout: float = 150.0) -> list:
    """Start every (job, world, dir) of ``runs`` at once, ``world`` ranks
    each on its own dir (which holds inputs.npz), and return each run's
    outputs in rank order.  A rank that fails, or the runs going past
    ``timeout`` seconds, fails the caller with the ranks' last output;
    every rank is stopped before this returns."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    ranks = []
    for job, world, tmp in runs:
        for r in range(world):
            log = open(tmp / f"rank{r}.log", "w+")
            ranks.append((job, r, log, subprocess.Popen(
                [sys.executable, __file__, job, str(r), str(world),
                 str(tmp)], env=env, stdout=log, stderr=subprocess.STDOUT)))
    deadline = time.monotonic() + timeout
    try:
        for *_, p in ranks:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for *_, p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
    tails = []
    for job, r, log, p in ranks:
        log.seek(0)
        tails.append(f"{job} rank {r} (exit {p.returncode}):\n"
                     + log.read()[-3000:])
        log.close()
    if any(p.returncode != 0 for *_, p in ranks):
        raise AssertionError(f"ranks failed or ran past {timeout} s:\n"
                             + "\n".join(tails))
    import torch
    return [[torch.load(tmp / f"out{r}.pt", weights_only=False)
             for r in range(world)] for _, world, tmp in runs]


# ----------------------------------------------------------------------
# jobs (run inside a rank)
# ----------------------------------------------------------------------
def _smoke(name: str, **kw):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name).smoke(), **kw)


def job_placements(rank: int, world: int, inputs) -> dict:
    """Every parameter of the olmoe and hymba smoke models distributed on
    a (2, 2) mesh under ``param_specs``: its global and local shapes and
    its spec; and the meshes that the group cannot hold."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch import sharding as S
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    from repro_torch.models import init_model
    mesh = make_local_mesh(2, "cpu")
    out = {"coordinate": mesh.get_coordinate(), "models": {}}
    for name in ("olmoe-1b-7b", "hymba-1.5b"):
        cfg = _smoke(name)
        model = init_model(cfg, seed=0, device="cpu", dtype=torch.float32)
        specs = S.param_specs(mesh, cfg, model)
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        S.distribute(model, mesh, specs)
        out["models"][name] = {
            n: (shapes[n], tuple(p.to_local().shape), tuple(specs[n]),
                p.requires_grad) for n, p in model.named_parameters()}
    errors = {}
    for what, fn in (("local_3", lambda: make_local_mesh(3, "cpu")),
                     ("production", lambda: make_production_mesh(
                         device_type="cpu"))):
        try:
            fn()
        except ValueError as e:
            errors[what] = str(e)
    out["mesh_errors"] = errors
    x = torch.arange(4 * 8 * 2, dtype=torch.float32).reshape(4, 8, 2)
    act = S.activation_constraint(mesh, seq_shard=True)
    xd = distribute_tensor(x, mesh, S.placements(mesh, S.P(None, None,
                                                            None)))
    out["constraint"] = {"local_unchanged": act(x) is x,
                         "act_local_shape": tuple(act(xd).to_local().shape),
                         "attrs": (act.dp, act.seq_shard)}
    return out


def _moe_module(cfg, inputs, tag: str):
    import torch
    from repro_torch.models import layers as L
    p = L.init_moe(cfg, None, "cpu")
    p.load_state_dict({n: torch.from_numpy(inputs[f"{tag}_{n}"])
                       for n in ("router", "we_gate", "we_up", "we_down")},
                      assign=True)
    return p


def job_moe(rank: int, world: int, inputs) -> dict:
    """``moe_shard_map`` on a (2, 2) mesh, EP (E 4) and TP (E 3), top-k 2:
    at capacity factor 1.0 (drops) the output and each rank's (experts,
    slots, kept) of its dispatch; at 8.0 (no drop) the output and the
    gradients of x, the router and the experts of a fixed cotangent's
    product, each gathered whole; the collective calls."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch import sharding as S
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe_sharded as MS
    mesh = make_local_mesh(2, "cpu")
    dp = ("data",)
    xpl = S.placements(mesh, S.P(dp, "model", None))
    x = torch.from_numpy(inputs["x"])
    out = {"coordinate": mesh.get_coordinate()}
    orig = MS._topk_dispatch
    for tag, e in (("ep", 4), ("tp", 3)):
        for cf in (1.0, 8.0):
            cfg = _smoke("olmoe-1b-7b", num_experts=e, top_k=2,
                         capacity_factor=cf)
            p = _moe_module(cfg, inputs, tag)
            S.distribute(p, mesh, S.param_specs(mesh, cfg, p))
            routes = []

            def record(*args):
                res = orig(*args)
                routes.append([t.numpy().copy() for t in res[1:4]])
                return res
            MS._topk_dispatch = record
            MS.reset_launches()
            xd = distribute_tensor(x, mesh, xpl).requires_grad_(cf > 1)
            try:
                y = MS.moe_shard_map(p, cfg, xd, mesh, dp)
            finally:
                MS._topk_dispatch = orig
            rec = {"routes": routes, "launches": dict(MS.launches),
                   "y_shard_dims": tuple(q.dim if q.is_shard() else None
                                         for q in y.placements)}
            if cf > 1:
                cot = distribute_tensor(torch.from_numpy(inputs["cot"]),
                                        mesh, xpl).to_local()
                loss = (y.to_local() * cot).sum()
                wrt = [xd, p.router, p.we_gate, p.we_up, p.we_down]
                grads = torch.autograd.grad(loss, wrt)
                rec["grads"] = [g.full_tensor().numpy() for g in grads]
                rec["launches_with_backward"] = dict(MS.launches)
            rec["y"] = y.full_tensor().detach().numpy()
            out[f"{tag}_{cf}"] = rec
    return out


def _reference_tree(inputs) -> dict:
    """The reference's parameter tree from inputs.npz's "param/<path>"
    arrays."""
    tree: dict = {}
    for key in inputs.files:
        if key.startswith("param/"):
            *head, leaf = key[len("param/"):].split("/")
            node = tree
            for k in head:
                node = node.setdefault(k, {})
            node[leaf] = inputs[key]
    return tree


def job_prefill(rank: int, world: int, inputs) -> dict:
    """The olmoe smoke model (the reference's parameters, fp32, capacity
    factor 8) through ``make_prefill_step`` with the sequence-sharded
    constraint on a (world // 2, 2) mesh: the logits, the collectives and
    the MoE calls that took the sharded path."""
    import torch
    from repro_torch import sharding as S
    from repro_torch.config import ParallelConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import from_reference, make_prefill_step
    from repro_torch.models import layers as L
    from repro_torch.models import moe_sharded as MS
    cfg = _smoke("olmoe-1b-7b", capacity_factor=8.0)
    model = from_reference(cfg, _reference_tree(inputs), device="cpu")
    mesh = make_local_mesh(2, "cpu")
    constraint = S.activation_constraint(mesh, seq_shard=True)
    plain = []
    orig = L.moe

    def count(*args, **kw):
        plain.append(1)
        return orig(*args, **kw)
    L.moe = count
    MS.reset_launches()
    try:
        logits = make_prefill_step(
            cfg, ParallelConfig(seq_shard_activations=True), constraint)(
            model, {"tokens": torch.from_numpy(inputs["tokens"])})
    finally:
        L.moe = orig
    return {"logits": logits.numpy(), "launches": dict(MS.launches),
            "plain_moe_calls": len(plain), "mesh": tuple(mesh.shape)}


TRAIN_ARCHS = ("qwen3-1.7b", "olmoe-1b-7b")
TRAIN = dict(steps=3, batch=4, seq=16, model_parallel=2)


def _quiet(*_):
    pass


def _train_arch(arch: str, tmp) -> dict:
    """``job_train``'s loop for one arch."""
    from repro_torch import sharding as S
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.models import steps as MS
    cfg = get_config(arch).smoke()
    d = tmp / arch
    run = train_loop(cfg, ckpt_dir=str(d / "sharded"),
                     save_every=1, log_every=1, log=_quiet,
                     device="cpu", **TRAIN)
    mesh = make_local_mesh(TRAIN["model_parallel"], "cpu")
    like = MS.state_shapes(cfg)
    specs = S.state_specs(mesh, cfg, like)
    want = S.named(mesh, specs)
    st = run["state"]
    placed = all(tuple(p.placements) == want["model"][n]
                 for n, p in st["model"].named_parameters())
    placed &= tuple(st["opt"].step.placements) == want["opt"].step
    for f in ("master", "mu", "nu"):
        placed &= all(tuple(t.placements) == getattr(want["opt"], f)[n]
                      for n, t in getattr(st["opt"], f).items())
    first, _ = ckpt.restore(like, str(d / "first"), step=0,
                            device="cpu", shardings=(mesh, specs))
    ckpt.save(first, 0, str(d / "resaved"))
    return {"losses": run["losses"], "placed": placed,
            "final_step": run["final_step"]}


def job_train(rank: int, world: int, inputs) -> dict:
    """``train_loop(model_parallel=2)`` on each smoke config of
    TRAIN_ARCHS from the step-0 checkpoint in DIR/<arch>/sharded (the
    reference's initial state, its parameters in inputs' "dtype", which
    ``layers.DTYPE`` is set to), saving every step there; its losses;
    the placements of the state it ends with against ``state_specs``';
    and the step-0 checkpoint in DIR/<arch>/first restored under the specs
    and saved again, into DIR/<arch>/resaved (rank 0 writes).
    ``layers.DTYPE`` is put back after."""
    from pathlib import Path

    import torch
    from repro_torch.models import layers as L
    tmp = Path(str(inputs["dir"]))
    old, L.DTYPE = L.DTYPE, getattr(torch, str(inputs["dtype"]))
    out = {}
    try:
        for arch in TRAIN_ARCHS:
            out[arch] = _train_arch(arch, tmp)
    finally:
        L.DTYPE = old
    return out


def job_norm(rank: int, world: int, inputs) -> dict:
    """``adamw.global_norm`` and ``adamw.update`` on a (2, 2) mesh:
    inputs.npz's arrays distributed under each spec of ``NORM_SPECS``, and
    the last gradient as a ``Partial`` over both mesh dims (each rank a
    quarter of it) beside a replicated master."""
    import torch
    from torch.distributed.tensor import DTensor, Partial, distribute_tensor
    from repro_torch import sharding as S
    from repro_torch.config import TrainConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import adamw
    mesh = make_local_mesh(2, "cpu")
    arrays = [torch.from_numpy(inputs[f"a{i}"]) for i in
              range(len(NORM_SPECS))]
    leaves = [distribute_tensor(a, mesh, S.placements(mesh, S.P(*spec)))
              for a, spec in zip(arrays, NORM_SPECS)]
    g = torch.from_numpy(inputs["g"])
    partial = DTensor.from_local(g / 4, mesh, [Partial(), Partial()],
                                 run_check=False)
    master = distribute_tensor(torch.from_numpy(inputs["m"]), mesh,
                               S.placements(mesh, S.P(None, None)))
    opt = adamw.init({"w": master})
    params, opt, m = adamw.update({"w": partial}, opt, TrainConfig())
    return {"norm": float(adamw.global_norm(leaves)),
            "norm_bf16": float(adamw.global_norm(
                [t.to(torch.bfloat16) for t in leaves])),
            "update_norm": float(m["grad_norm"]),
            "master": opt.master["w"].full_tensor().numpy(),
            "param": params["w"].full_tensor().float().numpy(),
            "mu": opt.mu["w"].full_tensor().numpy()}


def job_moe_train(rank: int, world: int, inputs) -> dict:
    """One train step of the olmoe smoke config (fp32 from seed 0,
    capacity factor 8: no pair drops) on DTensor state over a (2, 2) mesh
    with the sequence-sharded constraint, so every MoE layer runs
    ``moe_shard_map`` with its experts kept as DTensors, at grad_accum 1
    and 2: the metrics, the first moments gathered whole, and the MoE's
    collective calls."""
    import torch
    from repro_torch import sharding as S
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe_sharded as MS
    from repro_torch.models import steps
    cfg = _smoke("olmoe-1b-7b", capacity_factor=8.0)
    mesh = make_local_mesh(2, "cpu")
    specs = S.state_specs(mesh, cfg, steps.state_shapes(cfg))
    batch = {k: torch.from_numpy(inputs[k]) for k in ("tokens", "targets")}
    out = {}
    for accum in (1, 2):
        state = steps.init_state(cfg, seed=0, device="cpu",
                                 dtype=torch.float32,
                                 shardings=(mesh, specs))
        step = steps.make_train_step(
            cfg, TrainConfig(total_steps=10, warmup_steps=2),
            ParallelConfig(grad_accum=accum),
            S.activation_constraint(mesh, seq_shard=True))
        MS.reset_launches()
        state, m = step(state, batch)
        out[accum] = {"metrics": {k: float(v) for k, v in m.items()},
                      "mu": {n: t.full_tensor().numpy()
                             for n, t in state["opt"].mu.items()},
                      "launches": dict(MS.launches)}
    return out


NORM_SPECS = ((("data", "model"), None), (None, "model"), ("data", None),
              (None, None), ("model", "data"))

def job_sharded(rank: int, world: int, inputs) -> dict:
    """``job_train``, ``job_norm`` and ``job_moe_train`` in one set of
    ranks (each rank starts once)."""
    return {"train": job_train(rank, world, inputs),
            "norm": job_norm(rank, world, inputs),
            "moe_train": job_moe_train(rank, world, inputs)}


JOBS = {"placements": job_placements, "moe": job_moe,
        "prefill": job_prefill, "sharded": job_sharded}


def main() -> None:
    job, rank, world, tmp = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), Path(sys.argv[4])
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp / "store"), world),
        rank=rank, world_size=world)
    try:
        with np.load(tmp / "inputs.npz") as inputs:
            out = JOBS[job](rank, world, inputs)
        torch.save(out, tmp / f"out{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
