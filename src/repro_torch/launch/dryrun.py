"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step on a
fake process group of 256 or 512 ranks, in one process, with no card.

For each cell this runs the step of the shape's kind once (the train
step for train shapes, the prefill or serve step for inference shapes),
as rank 0 of torch's ``fake`` backend (``FakeStore``: collectives return
at once and move nothing) on ``make_production_mesh``, with DTensor state
and inputs placed under the reference's specs (``sharding``) and made
from ``launch/specs.py``'s meta stand-ins under ``FakeTensorMode`` (no
memory behind any tensor).  ``roofline.StepCounter`` reads the FLOPs,
bytes and collectives a rank's step dispatches, for the same record the
reference's ``dryrun.py`` writes from its compiled HLO:

  lower_s            seconds to trace the step (the port compiles
                     nothing: ``compile_s`` is 0.0)
  xla_cost_analysis  the dispatcher's FLOPs and bytes under the
                     reference's keys (every layer counted, not a loop
                     body once)
  argument_bytes     the rank's local shards of the step's arguments
  output_bytes       ... of its results; alias_bytes of those that are
                     arguments updated in place (the train state)
  temp_bytes         None: fake tensors keep no allocator to measure
  collectives_by_op / collective_counts / roofline

and, beyond the reference's keys, ``bytes_by_op_top``: the ATen
operations that moved the most bytes (the byte count depends on how
this torch decomposes its operations).

``memory_per_device`` in the roofline is the persistent bytes of the
rank's local shards (the arguments).  Tensors are fake CPU tensors, so
attention counts as its plain version (``attention_ref``), the full
S x S products as the reference's ``sdpa`` counts them.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k \\
      --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore

from .. import roofline as R
from .. import sharding as SH
from ..config import SHAPES, ParallelConfig, TrainConfig
from ..configs import get_config, list_configs
from ..models import steps as S
from ..optim.adamw import OptState
from . import specs as SP
from .mesh import PRODUCTION, make_production_mesh

DEVICE = "cpu"          # fake tensors: the plain paths, no kernel
TOP_OPS = 8             # ATen operations listed by the bytes they move


def skip_reason(cfg, shape) -> str:
    """Cells that are skipped by assignment rules (documented in DESIGN.md)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("full-attention arch: 500k-token dense KV decode is "
                "intentionally unsupported (sub-quadratic archs only)")
    return ""


@contextlib.contextmanager
def fake_group(world: int):
    """A default process group of ``world`` ranks on the fake backend, this
    process rank 0; destroyed on exit."""
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake(t: torch.Tensor) -> torch.Tensor:
    """A meta stand-in as a fake tensor on DEVICE (inside FakeTensorMode)."""
    return torch.empty(t.shape, dtype=t.dtype, device=DEVICE)


def _placed(tree, mesh, specs):
    """Stand-ins -> DTensors under ``specs``, each rank keeping its block."""
    if isinstance(tree, torch.nn.Module):
        for name, p in list(tree.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = tree.get_submodule(owner) if owner else tree
            mod._parameters[leaf] = torch.nn.Parameter(
                _fake(p), requires_grad=p.requires_grad)
    elif isinstance(tree, OptState):
        tree = OptState(*(_fake(t) if isinstance(t, torch.Tensor)
                          else {n: _fake(v) for n, v in t.items()}
                          for t in tree))
    elif isinstance(tree, dict):
        tree = {k: _fake(v) if isinstance(v, torch.Tensor) else v
                for k, v in tree.items()}
    else:
        tree = _fake(tree)
    return SH.distribute(tree, mesh, specs, src_data_rank=None)


def _local_bytes(tree) -> int:
    from torch.utils._pytree import tree_leaves
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    elif isinstance(tree, dict) and "model" in tree:
        tree = [list(tree["model"].parameters()), tree["opt"]]
    return int(sum(R._nbytes(t) for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor)))


def _step(cfg, shape, mesh, fsdp: bool, parallel: ParallelConfig):
    """(the step, its arguments as DTensors, argument bytes, alias
    bytes) for the cell."""
    constraint = SH.activation_constraint(
        mesh, seq_shard=parallel.seq_shard_activations)
    specs = SP.input_specs(cfg, shape)
    dp = SH.data_axes(mesh)
    if shape.kind in ("train", "prefill"):
        bspec = SH.batch_specs(mesh, cfg, shape)
        batch = {k: distribute_tensor(_fake(v), mesh,
                                      SH.placements(mesh, bspec[k]),
                                      src_data_rank=None)
                 for k, v in specs["batch"].items()}
    if shape.kind == "train":
        state = specs["state"]
        st_spec = SH.state_specs(mesh, cfg, state, fsdp=fsdp)
        state = {"model": _placed(state["model"], mesh, st_spec["model"]),
                 "opt": _placed(state["opt"], mesh, st_spec["opt"])}
        step = S.make_train_step(cfg, TrainConfig(), parallel,
                                 constraint=constraint)
        nbytes = _local_bytes(state)
        return step, (state, batch), nbytes + _local_bytes(batch), nbytes
    if shape.kind == "prefill":
        params = _placed(specs["params"], mesh,
                         SH.param_specs(mesh, cfg, specs["params"],
                                        fsdp=fsdp))
        step = S.make_prefill_step(cfg, parallel, constraint=constraint)
        return step, (params, batch), \
            _local_bytes(params) + _local_bytes(batch), 0
    params = _placed(specs["params"], mesh,
                     SH.param_specs(mesh, cfg, specs["params"], fsdp=fsdp))
    caches = _placed(specs["caches"], mesh,
                     SH.cache_specs(mesh, cfg, specs["caches"]))
    b = shape.global_batch
    rows = SH.placements(mesh, SH.P(SH.maybe(mesh, dp, b), None))
    token = distribute_tensor(_fake(specs["token"]), mesh, rows,
                              src_data_rank=None)
    cache_len = distribute_tensor(
        _fake(specs["cache_len"]), mesh,
        SH.placements(mesh, SH.P(SH.maybe(mesh, dp, b))), src_data_rank=None)
    args = (params, token, cache_len, caches)
    return S.make_serve_step(cfg), args, \
        _local_bytes(params) + _local_bytes([token, cache_len]) \
        + _local_bytes(caches), 0


def lower_cell(arch: str, shape_name: str, mesh, mesh_name: str,
               fsdp: bool = True, extra_tag: str = "",
               parallel: ParallelConfig = None) -> dict:
    """One cell's record (the reference's keys; see the module's
    docstring).  ``mesh`` is a DeviceMesh over the default group (fake or
    real)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    reason = skip_reason(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "chips": int(math.prod(mesh.shape)), "tag": extra_tag}
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec
    if parallel is None:
        # production default: microbatch the giant models' train step so
        # per-microbatch activations fit beside params+opt
        accum = 2 if (cfg.d_model >= 6144 and shape.kind == "train") else 1
        parallel = ParallelConfig(grad_accum=accum)
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args, arg_bytes, alias = _step(cfg, shape, mesh, fsdp,
                                             parallel)
        with R.StepCounter() as counter:
            out = step(*args)
    t_lower = time.time() - t0
    st = counter.stats
    out_bytes = _local_bytes(out[0]) + _local_bytes(out[1]) \
        if shape.kind == "train" else _local_bytes(out)
    rl = R.Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=rec["chips"],
        flops_per_device=st.flops, bytes_per_device=st.bytes_hbm,
        collective_bytes=st.collective_bytes,
        model_flops_total=R.model_flops(cfg, shape),
        memory_per_device=float(arg_bytes))
    rec.update({
        "status": "ok",
        "lower_s": round(t_lower, 1),
        "compile_s": 0.0,
        "xla_cost_analysis": {"flops_loop_body_once": st.flops,
                              "bytes_loop_body_once": st.bytes_hbm},
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "alias_bytes": alias,
        "temp_bytes": None,
        "collectives_by_op": {k: round(v) for k, v in st.coll_by_op.items()},
        "collective_counts": st.coll_counts,
        "roofline": rl.to_dict(),
        "bytes_by_op_top": dict(sorted(st.bytes_by_op.items(),
                                       key=lambda kv: -kv[1])[:TOP_OPS]),
    })
    return rec


def run_cells(archs, shapes, meshes, out_dir: Path, fsdp: bool = True,
              resume: bool = True) -> list:
    """Every cell of ``archs`` x ``shapes`` on each mesh ("single" 16 x 16,
    "multi" 2 x 16 x 16), each on a fake group of its ranks; one JSON file
    a cell in ``out_dir`` (a file already there is taken as the cell's
    record with ``resume``)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    results = []
    for mesh_name in meshes:
        multi = mesh_name == "multi"
        with fake_group(math.prod(PRODUCTION[multi][0])):
            mesh = make_production_mesh(multi_pod=multi, device_type=DEVICE)
            for arch in archs:
                for shape_name in shapes:
                    results.append(_run_one(arch, shape_name, mesh,
                                            mesh_name, out_dir, fsdp,
                                            resume))
    return results


def _run_one(arch, shape_name, mesh, mesh_name, out_dir, fsdp, resume):
    tag = f"{arch}__{shape_name}__{mesh_name}"
    path = out_dir / f"{tag}.json"
    if resume and path.exists():
        print(f"[cached] {tag}")
        return json.loads(path.read_text())
    print(f"[trace] {tag} ...", flush=True)
    try:
        rec = lower_cell(arch, shape_name, mesh, mesh_name, fsdp=fsdp)
    except Exception as e:        # record, keep going
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    path.write_text(json.dumps(rec, indent=1))
    extra = ""
    if rec["status"] == "ok":
        rl = rec["roofline"]
        extra = (f" dominant={rl['dominant']} mfu={rl['mfu']:.3f} "
                 f"mem/dev={rec['argument_bytes'] / 2**30:.2f}GiB "
                 f"trace={rec['lower_s']}s")
    elif rec["status"] == "error":
        extra = " " + rec["error"][:160]
    print(f"  -> {rec['status']}{extra}", flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args()

    archs = list_configs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    results = run_cells(archs, shapes, meshes, Path(args.out),
                        fsdp=not args.no_fsdp, resume=not args.no_resume)
    ok = sum(1 for r in results if r["status"] == "ok")
    sk = sum(1 for r in results if r["status"] == "skipped")
    err = [r for r in results if r["status"] == "error"]
    print(f"\n=== dry-run: {ok} ok, {sk} skipped, {len(err)} errors "
          f"of {len(results)} cells ===")
    for r in err:
        print(f"  ERROR {r['arch']} {r['shape']} {r['mesh']}: {r['error']}")
    return 1 if err else 0


if __name__ == "__main__":
    raise SystemExit(main())
