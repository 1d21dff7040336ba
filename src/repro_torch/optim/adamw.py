"""AdamW with fp32 master weights, global-norm clipping, cosine schedule.

The reference's optimizer on torch tensors.  The state holds, per
parameter name (as ``Model.named_parameters`` gives it):
  master: fp32 copy of the parameter   (source of truth)
  mu, nu: fp32 Adam moments
and the step counter, an int32 0-dim tensor.  Parameters stay bf16 for
compute; updates apply to the master and are re-cast: after ``update``
every parameter is the bf16 cast of its master, Mamba's fp32 ``A_log``
and ``D`` included, as in the reference (2 + 4+4+4 = 14 bytes a
parameter).

The arithmetic is the reference's, in fp32 tensors on the parameters'
device: the step counter, the learning rate, the clip scale and the bias
corrections are 0-dim fp32 tensors, never Python numbers, so a step
reads nothing back to the host.  ``update`` writes the new moments and
masters into the state's tensors in place (the reference makes new
arrays; holding two copies of a 1.7B-parameter state does not fit the
card beside its activations) and returns the new bf16 parameters.

On DTensor state (``sharding.distribute`` under ``state_specs``) the
same arithmetic runs on each rank's local shards: the masters, moments
and gradients of a parameter share its placements, so the update is
elementwise on the shards; the new parameter is the bf16 cast of the
master's shard under those placements.  A gradient that arrives with a
``Partial`` placement is reduced once, to its master's placements,
before the norm and the update read it.  ``global_norm`` sums each
element once across the ranks: a rank adds a leaf's local squares only
where its coordinate is 0 on every mesh dim the leaf is replicated over,
and one all-reduce over the mesh sums the ranks' totals.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from ..config import TrainConfig

Tensors = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    step: torch.Tensor
    master: Tensors
    mu: Tensors
    nu: Tensors


def init(params: Dict[str, torch.Tensor]) -> OptState:
    """Masters are fp32 copies of ``params`` (name -> tensor), moments
    fp32 zeros, the step 0, all on the parameters' device.  DTensor
    parameters give DTensor leaves of the same placements and a
    replicated step (``sharding.state_specs``' layout)."""
    first = next(iter(params.values()))
    with torch.no_grad():
        step = torch.zeros((), dtype=torch.int32, device=first.device)
        if isinstance(first, DTensor):
            mesh = first.device_mesh
            step = DTensor.from_local(step, mesh,
                                      [Replicate()] * mesh.ndim,
                                      run_check=False)
        return OptState(
            step=step,
            master={n: p.detach().to(torch.float32, copy=True)
                    for n, p in params.items()},
            mu={n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.items()},
            nu={n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.items()})


def cosine_schedule(tc: TrainConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (a 0-dim tensor) -> learning rate, an fp32 0-dim tensor:
    linear warm-up to ``tc.learning_rate``, then a cosine to 0 at
    ``tc.total_steps``."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = torch.clamp(step / max(tc.warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - tc.warmup_steps)
                           / max(tc.total_steps - tc.warmup_steps, 1),
                           0.0, 1.0)
        return tc.learning_rate * warm * 0.5 * (1 + torch.cos(math.pi * prog))
    return lr


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _counted_here(t: DTensor) -> bool:
    """Whether this rank holds the copy of ``t``'s shard that the norm
    counts: its coordinate is 0 on every mesh dim ``t`` replicates over."""
    coord = t.device_mesh.get_coordinate()
    return all(c == 0 for c, q in zip(coord, t.placements)
               if not q.is_shard())


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32: a local
    tensor.  DTensors (with no ``Partial`` placement) count each element
    once across the ranks, through one all-reduce over their mesh; every
    rank gets the same norm."""
    total, mesh = None, None
    for x in tensors:
        if isinstance(x, DTensor):
            mesh = x.device_mesh
            if not _counted_here(x):
                continue
        sq = torch.sum(torch.square(_local(x).to(torch.float32)))
        total = sq if total is None else total + sq
    if total is None:
        total = torch.zeros((), dtype=torch.float32,
                            device=mesh.device_type if mesh else None)
    if mesh is not None:
        total = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim,
                                   run_check=False).full_tensor()
    return torch.sqrt(total)


def _reduced(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient with ``Partial`` placements reduced once, to
    the placements of ``like`` (its master)."""
    if isinstance(g, DTensor) and any(q.is_partial() for q in g.placements):
        return g.redistribute(like.device_mesh, like.placements)
    return g


@torch.no_grad()
def update(grads: Tensors, state: OptState, tc: TrainConfig
           ) -> Tuple[Tensors, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step on ``grads`` (name -> tensor, the state's names).
    Returns (new bf16 parameters by name, the new state, metrics
    ``grad_norm`` and ``lr`` as 0-dim tensors).  The state's master and
    moment tensors are updated in place; its step is a new tensor."""
    grads = {n: _reduced(g, state.master[n]) for n, g in grads.items()}
    gnorm = global_norm(grads.values())
    scale = torch.clamp(tc.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = cosine_schedule(tc)(_local(step))
    b1, b2, eps = tc.beta1, tc.beta2, 1e-8
    stepf = _local(step).to(torch.float32)
    bc1 = 1 - torch.full_like(stepf, b1) ** stepf
    bc2 = 1 - torch.full_like(stepf, b2) ** stepf
    params = {}
    for name, g in grads.items():
        master = state.master[name]
        m, v, p = (_local(t) for t in (state.mu[name], state.nu[name],
                                       master))
        g = _local(g).to(torch.float32) * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        mhat = m / bc1
        vhat = v / bc2
        p.sub_(lr * (mhat / (torch.sqrt(vhat) + eps) + tc.weight_decay * p))
        params[name] = p.to(torch.bfloat16)
        if isinstance(master, DTensor):
            params[name] = DTensor.from_local(
                params[name], master.device_mesh, master.placements,
                run_check=False, shape=master.shape,
                stride=master.stride())
    new_state = OptState(step=step, master=state.master, mu=state.mu,
                         nu=state.nu)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
