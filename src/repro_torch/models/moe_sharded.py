"""The MoE over a device mesh with its exchange written out, as the
reference's ``models/moe_sharded.py`` writes it with ``shard_map``; here
on ``torch.distributed``: DTensors in and out, local tensors and
autograd-aware collectives inside.

EP path (num_experts % model axis == 0):
  1. each rank routes its own tokens (``layers.moe_route``'s stable top-k,
     ``layers.moe_slots``'s count) into [E, C_src, d];
  2. all-to-all over "model": split E, concatenate the source shards
     -> [E/ep, ep*C_src, d];
  3. the grouped expert GEMMs with the rank's expert shard (weights
     all-gathered over "data");
  4. all-to-all back, and the combine on the rank.

TP fallback (E not divisible): every model rank gathers the sequence over
"model", runs all experts with its d_ff shard, and the partial outputs
are reduce-scattered over "model" back onto the sequence.

Activations enter and leave sharded P(dp, "model", None), so each rank
dispatches only its sequence shard.  Capacity is per (expert, source
shard): ``max(int(cf * t_loc * k / E), 1)`` over the rank's t_loc
tokens, where ``layers.moe`` counts per batch row.

The reference's collectives split and concatenate on any axis;
``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
``all_to_all_single`` work on dim 0, so the helpers stack the shards on
a new leading dim and move it to the reference's axis, or split that
axis's blocks onto it (the all-to-all's axes are moved around it by
``_ep_body``).  Each is an
autograd ``Function`` whose backward is its transpose (all-gather <->
reduce-scatter, all-to-all itself), as JAX differentiates the
``shard_map``; under ``torch.utils.checkpoint`` the recompute calls them
again in the same order on every rank.  ``launches`` counts the
collective calls, forward and backward.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate

from ..config import ModelConfig
from ..sharding import P, _axis_size, mesh_sizes, placements
from . import layers as L

launches = {"all_gather": 0, "all_to_all": 0, "reduce_scatter": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ----------------------------------------------------------------------
# collectives on any dim
# ----------------------------------------------------------------------
def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's shards concatenated along ``dim``, in rank order: the
    shards stacked on a new leading dim, moved to ``dim`` and merged into
    it (a view when the group has one rank)."""
    launches["all_gather"] += 1
    n, src = dist.get_world_size(group), x.contiguous()
    out = src.new_empty((n * src.shape[0],) + src.shape[1:])
    dist.all_gather_into_tensor(out, src, group=group)
    return out.view((n,) + src.shape).movedim(0, dim).flatten(dim, dim + 1)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's sum of ``x``, this rank's block of ``dim``: the blocks
    split onto a new leading dim (no copy when the group has one rank)."""
    launches["reduce_scatter"] += 1
    n = dist.get_world_size(group)
    src = x.unflatten(dim, (n, -1)).movedim(dim, 0).contiguous()
    out = src.new_empty(src.shape[1:])
    dist.reduce_scatter_tensor(out, src.flatten(0, 1), op=dist.ReduceOp.SUM,
                               group=group)
    return out


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block j of dim 0 to rank j; block i of the result from rank i."""
    launches["all_to_all"] += 1
    src = x.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


# ----------------------------------------------------------------------
# local dispatch and combine
# ----------------------------------------------------------------------
def _topk_dispatch(cfg: ModelConfig, x: torch.Tensor, router: torch.Tensor,
                   cap: int):
    """x [T, d] -> buf [E, cap, d], (flat_e, pos, keep, top_w) of its
    T * k (token, k) pairs, token-major: ``layers.moe_route`` and
    ``layers.moe_slots`` over the T tokens as one row."""
    e, k = cfg.num_experts, cfg.top_k
    top_w, top_e = L.moe_route(SimpleNamespace(router=router), cfg, x[None])
    pos, keep = L.moe_slots(top_e, e, cap)
    flat_e, pos, keep = top_e.reshape(-1), pos[0], keep[0]
    # dropped pairs land in a spare slot past the last, cut off after
    buf = x.new_zeros((e, cap + 1, x.shape[1])).index_put(
        (flat_e, torch.where(keep, pos, cap)),
        x.repeat_interleave(k, 0))[:, :cap]
    return buf, flat_e, pos, keep, top_w[0]


def _combine(out_rows: torch.Tensor, flat_e, pos, keep, top_w, cap: int,
             t: int, k: int) -> torch.Tensor:
    """out_rows [E * cap, d] -> [T, d]: each token's k weighted expert
    outputs summed (a dropped pair reads its expert's last slot and is
    zeroed)."""
    gathered = out_rows[flat_e * cap + torch.clamp(pos, max=cap - 1)]
    gathered = torch.where(keep[:, None], gathered, gathered.new_zeros(()))
    w = top_w.reshape(-1, 1).to(gathered.dtype)
    return (gathered * w).reshape(t, k, -1).sum(1)


def _experts(buf, wg, wu, wd) -> torch.Tensor:
    """The grouped expert GEMMs: [E', C, d] -> [E', C, d]."""
    h = L.silu(torch.einsum("ecd,edf->ecf", buf, wg)) \
        * torch.einsum("ecd,edf->ecf", buf, wu)
    return torch.einsum("ecf,efd->ecd", h, wd)


def _ep_body(cfg, mesh, cap, xl, router, wg, wu, wd) -> torch.Tensor:
    """xl [B_loc, S_loc, d]; wg [E/ep, d/dp, f] -> [B_loc, S_loc, d]."""
    data, model = mesh.get_group("data"), mesh.get_group("model")
    e, k, ep = cfg.num_experts, cfg.top_k, mesh_sizes(mesh)["model"]
    router = _AllGather.apply(router, 0, data)
    wg = _AllGather.apply(wg, 1, data)
    wu = _AllGather.apply(wu, 1, data)
    wd = _AllGather.apply(wd, 2, data)
    bl, sl, d = xl.shape
    buf, flat_e, pos, keep, top_w = _topk_dispatch(
        cfg, xl.reshape(bl * sl, d), router, cap)
    # rows to their expert's shard: [E, cap, d] arrives as [ep (source),
    # E/ep, cap, d] -> [E/ep, ep * cap, d]
    buf = _AllToAll.apply(buf, model).reshape(ep, e // ep, cap, d) \
        .transpose(0, 1).reshape(e // ep, ep * cap, d)
    out = _experts(buf, wg, wu, wd)
    # and back: [E/ep, ep * cap, d] -> [ep (destination), E/ep, cap, d]
    out = out.reshape(e // ep, ep, cap, d).transpose(0, 1)
    out = _AllToAll.apply(out, model).reshape(e * cap, d)
    y = _combine(out, flat_e, pos, keep, top_w, cap, bl * sl, k)
    return y.reshape(bl, sl, d).to(xl.dtype)


def _tp_body(cfg, mesh, cap, xl, router, wg, wu, wd) -> torch.Tensor:
    """xl [B_loc, S_loc, d] sequence-sharded; wg [E, d/dp, f/ep]: every
    model rank sees the same tokens (the sequence gathered), runs all
    experts with its d_ff shard, and the partial outputs are summed and
    scattered back onto the sequence (Megatron-style MoE tensor
    parallelism)."""
    data, model = mesh.get_group("data"), mesh.get_group("model")
    e, k = cfg.num_experts, cfg.top_k
    router = _AllGather.apply(router, 0, data)
    wg = _AllGather.apply(wg, 1, data)
    wu = _AllGather.apply(wu, 1, data)
    wd = _AllGather.apply(wd, 2, data)
    x_full = _AllGather.apply(xl, 1, model)
    bl, s_full, d = x_full.shape
    t_full = bl * s_full
    cap_tp = max(int(cfg.capacity_factor * t_full * k / e), 1)
    buf, flat_e, pos, keep, top_w = _topk_dispatch(
        cfg, x_full.reshape(t_full, d), router, cap_tp)
    out = _experts(buf, wg, wu, wd)                 # partial over f
    y = _combine(out.reshape(e * cap_tp, d), flat_e, pos, keep, top_w,
                 cap_tp, t_full, k)
    y = _ReduceScatter.apply(y.reshape(bl, s_full, d), 1, model)
    return y.to(xl.dtype)


def _local(t: torch.Tensor, mesh, spec: P) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a local tensor is taken
    as replicated: its block is a slice, no exchange).  Its gradient is
    this rank's contribution: on the mesh dims the spec does not shard,
    a partial sum, which DTensor adds up across ranks (the reference's
    ``shard_map`` transposes a replicated input to a psum likewise)."""
    pl = placements(mesh, spec)
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    grad = [q if q.is_shard() else Partial() for q in pl]
    return t.redistribute(mesh, pl).to_local(grad_placements=grad)


def moe_shard_map(p: L.MoE, cfg: ModelConfig, x: DTensor, mesh,
                  dp) -> DTensor:
    """x: [B, S, d] DTensor (any placements; redistributed to P(dp,
    "model", None)) -> the MoE's output as a DTensor sharded so.  The
    weights ``p.router`` / ``we_*`` are DTensors (``sharding.distribute``)
    or local tensors, taken under the reference's ``wspecs``."""
    e, k = cfg.num_experts, cfg.top_k
    ep = mesh_sizes(mesh)["model"]
    b, s, _ = x.shape
    t_loc = (b // _axis_size(mesh, dp)) * (s // ep)
    cap = max(int(cfg.capacity_factor * t_loc * k / e), 1)
    expert_parallel = e % ep == 0
    wspecs = {
        "router": P("data", None),
        "we_gate": P("model", "data", None) if expert_parallel
        else P(None, "data", "model"),
        "we_up": P("model", "data", None) if expert_parallel
        else P(None, "data", "model"),
        "we_down": P("model", None, "data") if expert_parallel
        else P(None, "model", "data"),
    }
    x_spec = P(dp, "model", None)
    ws = [_local(getattr(p, n), mesh, wspecs[n]) for n in wspecs]
    body = _ep_body if expert_parallel else _tp_body
    y = body(cfg, mesh, cap, _local(x, mesh, x_spec), *ws)
    return DTensor.from_local(y, mesh, placements(mesh, x_spec),
                              run_check=False)
