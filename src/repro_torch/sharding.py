"""Sharding rules: logical axes -> mesh axes with a divisibility fallback,
as the reference's ``sharding.py`` lays them out, on ``torch.distributed``.

Train mode: 2D sharding — tensor-parallel dims (heads / d_ff / experts /
vocab / d_inner) on "model", FSDP on "data" over the other large dim.
Optimizer state mirrors the parameters' specs.  Batch is data-parallel
over ("pod", "data") on the multi-pod mesh: parameters shard within a pod
and replicate across pods.  Serve mode (``fsdp=False``): tensor
parallelism only.  KV caches shard batch over "data" and kv-heads over
"model" when divisible, else the sequence dim takes "model".  A dim that
its axis does not divide stays unsharded.

A spec is a ``P``: one entry a tensor dim, each None (replicated), a mesh
axis name, or a tuple of names (sharded over their product, in order).
The rules read only a mesh's axis names and sizes (``mesh_dim_names`` and
``shape``), so they take a ``DeviceMesh`` or a ``MeshShape`` alike: the
production meshes' specs come out without 256 or 512 ranks.

The port keeps a model's layers in a ``ModuleList``, one parameter a
layer, where the reference stacks them on a leading L axis: a per-layer
parameter's spec is the reference's without its leading None, and its
divisibility is tested on the same per-layer dims.  Specs are keyed by
the port's parameter names (``Model.named_parameters``), mapped onto the
reference's tree paths by ``models.convert.reference_path``.

``named`` turns specs into DTensor placements, ``distribute`` a state's
tensors into DTensors, and ``activation_constraint`` makes the callable
the model's forward applies at the reference's constraint points.

A step on DTensor state (``models.steps``) computes on local tensors:
each rank takes the batch rows of ``row_layout`` (the data axes, and the
model axis too when the rows divide over every rank) and gathers the
parameters whole, their gradients ``Partial`` over the mesh dims that
split the rows; ``local_rows`` and ``gather`` do the two.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from .config import ModelConfig, ShapeSpec
from .models.convert import reference_path
from .optim.adamw import OptState

# "2d" = TP over "model" + FSDP over "data" (default); "dp_only" = no
# tensor parallelism: the model axis joins data parallelism and
# parameters shard over every rank
MODE = "2d"


class P(tuple):
    """A partition spec: one entry a tensor dim.  A tuple of one name is
    kept as the name, and a list as a tuple, as JAX's ``PartitionSpec``
    keeps them, so specs compare entry for entry."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return e[0] if len(e) == 1 else tuple(e)
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes without a process group, as
    ``DeviceMesh`` gives them: for the rules at production shapes."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or ``MeshShape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# ----------------------------------------------------------------------
def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = mesh_sizes(mesh)
    if isinstance(axis, (tuple, list)):
        return int(np.prod([sizes[a] for a in axis]))
    return sizes[axis]


def maybe(mesh, axis, dim: int):
    """Use ``axis`` for a dim only when it divides evenly."""
    return axis if axis is not None and dim % _axis_size(mesh, axis) == 0 \
        else None


def data_axes(mesh) -> Tuple[str, ...]:
    """Batch data-parallel axes: ("pod", "data") on multi-pod meshes; in
    dp_only mode the "model" axis joins data parallelism."""
    dp = ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
    if MODE == "dp_only":
        dp = dp + ("model",)
    return dp


# ----------------------------------------------------------------------
# parameter specs by name
# ----------------------------------------------------------------------
def _param_spec(mesh, cfg: ModelConfig, path: Tuple[str, ...],
                dims: Tuple[int, ...], fsdp: bool) -> P:
    """The spec of one parameter of (per-layer) shape ``dims`` at the
    reference's tree path ``path``."""
    name = path[-1]
    if MODE == "dp_only":
        dp = data_axes(mesh) if fsdp else None
        mdl = None
    else:
        dp = "data" if fsdp else None
        mdl = "model"

    if name in ("embed",):
        return P(maybe(mesh, mdl, dims[0]), maybe(mesh, dp, dims[1]))
    if name == "lm_head":
        return P(maybe(mesh, dp, dims[0]), maybe(mesh, mdl, dims[1]))
    if name in ("final_norm", "attn_norm", "mlp_norm", "ssm_norm",
                "cross_norm", "q_norm", "k_norm", "dt_bias_"):
        return P(*([None] * len(dims)))
    if name in ("wq", "wk", "wv"):
        return P(maybe(mesh, dp, dims[0]), maybe(mesh, mdl, dims[1]))
    if name == "wo":
        return P(maybe(mesh, mdl, dims[0]), maybe(mesh, dp, dims[1]))
    if name in ("bq", "bk", "bv"):
        return P(maybe(mesh, mdl, dims[0]))
    if name in ("w_gate", "w_up", "wi"):
        return P(maybe(mesh, dp, dims[0]), maybe(mesh, mdl, dims[1]))
    if name in ("w_down",):
        return P(maybe(mesh, mdl, dims[0]), maybe(mesh, dp, dims[1]))
    if name == "router":
        return P(maybe(mesh, dp, dims[0]), None)
    if name in ("we_gate", "we_up"):              # [E, D, F]
        if dims[0] % _axis_size(mesh, mdl) == 0:  # expert parallel
            return P(mdl, maybe(mesh, dp, dims[1]), None)
        return P(None, maybe(mesh, dp, dims[1]), maybe(mesh, mdl, dims[2]))
    if name == "we_down":                         # [E, F, D]
        if dims[0] % _axis_size(mesh, mdl) == 0:
            return P(mdl, None, maybe(mesh, dp, dims[2]))
        return P(None, maybe(mesh, mdl, dims[1]), maybe(mesh, dp, dims[2]))
    if name == "in_proj":                         # [D, 2*di]
        return P(maybe(mesh, dp, dims[0]), maybe(mesh, mdl, dims[1]))
    if name == "conv_w":                          # [kc, di]
        return P(None, maybe(mesh, mdl, dims[1]))
    if name in ("conv_b", "D", "dt_bias"):        # [di]
        return P(maybe(mesh, mdl, dims[0]))
    if name == "x_proj":                          # [di, rk+2N]
        return P(maybe(mesh, mdl, dims[0]), None)
    if name == "dt_proj":                         # [rk, di]
        return P(None, maybe(mesh, mdl, dims[1]))
    if name == "A_log":                           # [di, N]
        return P(maybe(mesh, mdl, dims[0]), None)
    if name == "out_proj":                        # [di, D]
        return P(maybe(mesh, mdl, dims[0]), maybe(mesh, dp, dims[1]))
    return P(*([None] * len(dims)))               # default: replicate


def _tensors(params) -> Mapping[str, torch.Tensor]:
    """Name -> tensor of a module's parameters or of a mapping."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def param_specs(mesh, cfg: ModelConfig, params,
                fsdp: bool = True) -> Dict[str, P]:
    """Spec of every parameter of a ``Model`` (or a name -> tensor
    mapping, as an ``OptState`` field holds them), by the port's name."""
    return {name: _param_spec(mesh, cfg,
                              tuple(reference_path(name)[0].split("/")),
                              tuple(t.shape), fsdp)
            for name, t in _tensors(params).items()}


def state_specs(mesh, cfg: ModelConfig, state: Dict,
                fsdp: bool = True) -> Dict:
    """Specs of a ``{"model", "opt"}`` train state: master, mu and nu
    mirror the parameters' specs; the step is replicated."""
    opt = state["opt"]
    return {
        "model": param_specs(mesh, cfg, state["model"], fsdp),
        "opt": OptState(step=P(),
                        master=param_specs(mesh, cfg, opt.master, fsdp),
                        mu=param_specs(mesh, cfg, opt.mu, fsdp),
                        nu=param_specs(mesh, cfg, opt.nu, fsdp)),
    }


# ----------------------------------------------------------------------
# batch / cache specs
# ----------------------------------------------------------------------
def batch_specs(mesh, cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, P]:
    dp = data_axes(mesh)
    specs: Dict[str, P] = {"tokens": P(dp, None)}
    if shape.kind == "train":
        specs["targets"] = P(dp, None)
    if cfg.encoder_layers:
        specs["frames"] = P(dp, None, None)
    if cfg.vision_prefix:
        specs["vision_embeds"] = P(dp, None, None)
    return specs


def cache_specs(mesh, cfg: ModelConfig,
                caches: Mapping[str, torch.Tensor]) -> Dict[str, P]:
    """Decode cache specs: [L, B, S, KV, D] attention caches, Mamba's
    [L, B, kc - 1, di] conv and [L, B, di, N] state (stacked over layers
    in both packages)."""
    dp = data_axes(mesh)

    def spec(name: str, shp) -> P:
        if name in ("k", "v", "cross_k", "cross_v"):
            _, b, s, kv, hd = shp
            if kv % _axis_size(mesh, "model") == 0:
                return P(None, maybe(mesh, dp, b), None, "model", None)
            return P(None, maybe(mesh, dp, b), maybe(mesh, "model", s),
                     None, None)
        if name == "conv":
            return P(None, maybe(mesh, dp, shp[1]), None,
                     maybe(mesh, "model", shp[3]))
        if name == "ssm":
            return P(None, maybe(mesh, dp, shp[1]),
                     maybe(mesh, "model", shp[2]), None)
        return P(*([None] * len(shp)))

    return {name: spec(name, tuple(t.shape)) for name, t in caches.items()}


def logits_spec(mesh, cfg: ModelConfig) -> P:
    return P(data_axes(mesh), None, maybe(mesh, "model", cfg.vocab_size))


# ----------------------------------------------------------------------
# specs -> DTensor placements
# ----------------------------------------------------------------------
def placements(mesh, spec: P) -> tuple:
    """One placement a mesh dim: ``Shard(d)`` where tensor dim d's entry
    names that axis, else ``Replicate()``.  An entry naming two axes
    shards its dim over both mesh dims, in the mesh's order (DTensor's
    nesting order), which must be the entry's."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in
               ((entry,) if isinstance(entry, str) else entry)]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: entry {entry} names mesh axes out "
                             f"of the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]} named "
                                 "by two dims")
            out[i] = Shard(d)
    return tuple(out)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def named(mesh, tree):
    """A spec tree (dicts, ``OptState``s, ``P`` leaves) -> the same tree
    of placement tuples."""
    if isinstance(tree, P):
        return placements(mesh, tree)
    if isinstance(tree, dict):
        return {k: named(mesh, v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(named(mesh, v) for v in tree))
    raise TypeError(f"not a spec tree: {type(tree).__name__}")


def distribute(tree, mesh, specs, src_data_rank: Optional[int] = 0):
    """A state's tensors as DTensors on ``mesh`` under ``specs`` (the tree
    ``param_specs`` / ``state_specs`` / ``cache_specs`` gives): a
    ``Model``'s parameters are replaced in place by DTensor parameters
    (its ``requires_grad`` kept) and the module returned; dicts and
    ``OptState``s come back as new containers.  Each rank passes the same
    values (a model carried over by ``convert.from_reference``, or made
    from one seed): ``src_data_rank`` (``distribute_tensor``'s) sends rank
    0's, or with None each rank keeps its own block, with no exchange."""
    if isinstance(specs, P):
        return distribute_tensor(tree, mesh, placements(mesh, specs),
                                 src_data_rank=src_data_rank)
    if isinstance(tree, nn.Module):
        for name, p in list(tree.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = tree.get_submodule(owner) if owner else tree
            setattr(mod, leaf, nn.Parameter(
                distribute(p.detach(), mesh, specs[name], src_data_rank),
                requires_grad=p.requires_grad))
        return tree
    if isinstance(tree, dict):
        return {k: distribute(v, mesh, specs[k], src_data_rank)
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(distribute(t, mesh, s, src_data_rank)
                            for t, s in zip(tree, specs)))
    raise TypeError(f"cannot distribute a {type(tree).__name__}")


# ----------------------------------------------------------------------
def row_layout(mesh, rows: int) -> tuple:
    """The placements of the batch rows a rank computes on in a step on
    DTensor state: ``Shard(0)`` on the data axes, and on every other mesh
    dim too when ``rows`` divide over all the ranks (the model axis then
    joins data parallelism in the compute, each rank on its own rows),
    else ``Replicate()`` there (the ranks of a model group compute the
    same rows)."""
    dp = data_axes(mesh)
    every = rows % mesh.size() == 0
    return tuple(Shard(0) if (n in dp or every) else Replicate()
                 for n in mesh.mesh_dim_names)


def local_rows(t: torch.Tensor, mesh, layout: tuple,
               dim: int = 0) -> torch.Tensor:
    """This rank's rows of ``t`` under ``layout`` (``row_layout``'s, the
    rows on ``dim``): a DTensor is redistributed to it, a local tensor is
    taken as the whole (replicated) tensor.  Slicing a dim a placement
    already splits takes a block of the local tensor, with no
    exchange."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    pl = [Shard(dim) if q.is_shard() else Replicate() for q in layout]
    return t.redistribute(mesh, pl).to_local()


def gather(p: DTensor, layout: tuple) -> torch.Tensor:
    """The whole of parameter ``p`` on every rank, as a local tensor whose
    gradient is this rank's contribution: ``Partial`` over the mesh dims
    ``layout`` splits the rows on (their sum, once, lands in ``p``'s
    placements: a reduce-scatter where ``p`` is sharded, an all-reduce
    where it is replicated), replicated over the others."""
    mesh = p.device_mesh
    grad = [Partial() if q.is_shard() else Replicate() for q in layout]
    return p.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=grad)


def activation_constraint(mesh, seq_shard: bool = False, local=None):
    """The constraint the forward applies at the reference's points.

    kind="act":     between-layer residuals [B, S, D]: batch over the data
                    axes, and the sequence over "model" with
                    ``seq_shard`` (sequence parallelism).
    kind="moe_buf": expert dispatch buffers [B, E, C, D]: batch over data,
                    E over "model" when divisible (expert parallelism).
    kind="moe_h":   expert hidden [B, E, C, F]: as moe_buf, F over "model"
                    in the TP fallback.

    A DTensor is redistributed to the kind's placements; a local tensor
    comes back unchanged (the model around it runs replicated on every
    rank, as code inside a ``shard_map`` would, or on this rank's rows).
    ``.mesh``, ``.dp`` and ``.seq_shard`` let the model pick the
    mesh-aware MoE; ``.local`` says how a local activation lies in the
    global one: None when it is the whole, else the ``row_layout`` of
    the rows it holds."""
    dp = data_axes(mesh)
    seq = "model" if seq_shard else None

    def f(x, kind: str = "act"):
        if not isinstance(x, DTensor):
            return x
        if kind == "act":
            spec = P(dp, seq, None)
        else:
            ep = maybe(mesh, "model", x.shape[1])
            if kind == "moe_h" and ep is None:
                spec = P(dp, None, None, maybe(mesh, "model", x.shape[-1]))
            else:
                spec = P(dp, ep, None, None)
        return x.redistribute(mesh, placements(mesh, spec))

    f.mesh = mesh
    f.dp = dp
    f.seq_shard = seq_shard
    f.local = local
    return f
