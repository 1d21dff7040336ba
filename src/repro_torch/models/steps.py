"""Train, prefill and serve steps, as the reference's ``models/steps.py``
makes them.

``make_train_step`` returns
    (state, batch) -> (state, metrics)
with per-layer activation checkpointing (``parallel.remat``), the loss's
vocab projection chunked over the sequence, optional gradient
accumulation over micro-batches, global-norm clipping and AdamW.  A state
is ``{"model": Model, "opt": OptState}`` (``init_state``); the step
writes the new parameters into the model and the optimizer's tensors in
place and returns the same dict.  ``make_prefill_step`` is the no-grad
forward that projects only the last position to the vocabulary (the
[B, S, V] logits are never formed); ``make_serve_step`` the one-token
decode step against dense caches with a greedy next token.

All three take DTensor state as well (``sharding.distribute`` under
``state_specs`` / ``param_specs`` / ``cache_specs``, the batch under
``batch_specs``), as the reference's steps take sharded arrays under
``jit``.  Each rank then computes on local tensors: the batch rows of
``sharding.row_layout`` (the data axes, and the model axis too when the
rows divide over every rank), with the parameters gathered whole for the
step (``sharding.gather``: FSDP over the whole mesh).  The backward
returns each gradient in its parameter's placements, summed once over
the ranks that split the rows (a reduce-scatter, or an all-reduce for a
replicated parameter); each rank's loss is scaled by its share of the
rows, so the sum is the global batch's mean, as one device computes it.
On the sequence-sharded MoE path (``model.sharded_moe``) the experts and
router stay DTensors and ``moe_sharded`` exchanges the tokens.  The
updated parameters, masters and moments keep their placements.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.utils.checkpoint import checkpoint

from .. import sharding as SH
from ..config import ModelConfig, ParallelConfig, TrainConfig
from ..optim import adamw
from . import layers as L
from . import model as M


def _pick_chunks(s: int, target: int = 512) -> int:
    if s <= target:
        return s
    for c in range(target, 0, -1):
        if s % c == 0:
            return c
    return s


def _chunk_loss(h: torch.Tensor, head: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
    """Summed next-token cross entropy of one sequence chunk: h [B, c, d],
    t [B, c]; the logits cast to fp32 after the product, as the
    reference's."""
    logits = L.matmul(h, head).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, t[..., None].long())[..., 0]
    return torch.sum(logz - gold)


def make_loss_fn(cfg: ModelConfig, parallel: ParallelConfig,
                 constraint=None):
    """Next-token CE with the vocab projection chunked over the sequence,
    each chunk under ``torch.utils.checkpoint``: the full [B, S, V] fp32
    logits never exist, in the forward or the backward.  ``constraint``
    (``sharding.activation_constraint``) goes to ``forward``."""
    def loss_fn(model: M.Model, batch: Dict) -> torch.Tensor:
        hidden = M.forward(cfg, model, batch, remat=parallel.remat,
                           constraint=constraint, return_hidden=True)
        head = M.lm_head(cfg, model)
        targets = batch["targets"]
        b, s, _ = hidden.shape
        c = _pick_chunks(s)
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(0, s, c):
            total = total + checkpoint(_chunk_loss, hidden[:, i:i + c], head,
                                       targets[:, i:i + c],
                                       use_reentrant=False)
        return total / float(b * s)
    return loss_fn


class _Shards:
    """A step's view of DTensor parameters: the mesh, this rank's
    ``row_layout`` and share of the batch rows, the parameters gathered
    whole (all but the MoE's on its sharded path), and the constraint
    that tells the model how its local activations lie."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, DTensor],
                 rows: int, seq: int, constraint, micro: int = 1):
        self.mesh = next(iter(params.values())).device_mesh
        self.layout = SH.row_layout(self.mesh, rows)
        self.split = [q.is_shard() for q in self.layout]
        self.constraint = SH.activation_constraint(
            self.mesh, getattr(constraint, "seq_shard", False),
            local=self.layout)
        keep = M.sharded_moe(cfg, self.constraint, rows // micro, seq)
        self.params = {n: p for n, p in params.items()
                       if not (keep and ".moe." in n)}

    @classmethod
    def of(cls, cfg: ModelConfig, model: M.Model, tokens: torch.Tensor,
           constraint, micro: int = 1) -> Optional["_Shards"]:
        """None for a model of local tensors; ``micro``: the micro-batches
        a step splits the rows into (the MoE sees a micro-batch's)."""
        params = dict(model.named_parameters())
        if not isinstance(next(iter(params.values())), DTensor):
            return None
        return cls(cfg, params, tokens.shape[0], tokens.shape[1],
                   constraint, micro)

    def rows(self, batch: Dict, dim: int = 0) -> Dict:
        return {k: SH.local_rows(v, self.mesh, self.layout, dim)
                for k, v in batch.items()}

    @contextlib.contextmanager
    def swapped(self, model: M.Model, grad: bool):
        """The model's parameters replaced by their gathered whole for the
        block (with ``grad``, through ``sharding.gather``; without, plain
        copies), restored after."""
        saved = []
        try:
            for name, p in self.params.items():
                owner, _, leaf = name.rpartition(".")
                mod = model.get_submodule(owner) if owner else model
                saved.append((mod, leaf, mod._parameters[leaf]))
                mod._parameters[leaf] = SH.gather(p, self.layout) if grad \
                    else p.full_tensor()
            yield
        finally:
            for mod, leaf, p in saved:
                mod._parameters[leaf] = p

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks that split the rows (each rank
        holds its rows' share): one all-reduce."""
        pl = [Partial() if sp else Replicate() for sp in self.split]
        return DTensor.from_local(x, self.mesh, pl,
                                  run_check=False).full_tensor()

    def wrap(self, x: torch.Tensor, dim: int = 0) -> DTensor:
        """Local rows back into a DTensor of the global batch."""
        pl = [q if not q.is_shard() else type(q)(dim) for q in self.layout]
        return DTensor.from_local(x, self.mesh, pl, run_check=False)


def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    parallel: ParallelConfig, constraint=None):
    loss_fn = make_loss_fn(cfg, parallel, constraint)

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        """batch: ``tokens``/``targets`` int [B, S] on the model's device
        (and an encdec model's ``frames``, a vlm's ``vision_embeds``; a
        micro-batch slices every key on its first dim; on DTensor state,
        DTensors under ``batch_specs`` or whole local tensors, and each
        rank's micro-batches slice its own rows) -> (the state, updated
        in place; metrics ``loss``, ``grad_norm``, ``lr`` as 0-dim fp32
        local tensors, read nowhere in the step)."""
        model, opt = state["model"], state["opt"]
        names, params = zip(*model.named_parameters())
        sh = _Shards.of(cfg, model, batch["tokens"], constraint,
                        parallel.grad_accum)
        fn, share = loss_fn, 1.0
        if sh is not None:          # this rank's rows, its share of them
            rows = batch["tokens"].shape[0]
            batch = sh.rows(batch)
            fn = make_loss_fn(cfg, parallel, sh.constraint)
            share = batch["tokens"].shape[0] / rows

        def value_and_grad(mb):
            with sh.swapped(model, True) if sh is not None \
                    else contextlib.nullcontext():
                loss = fn(model, mb) * share
                grads = torch.autograd.grad(loss, params, allow_unused=True)
            return loss.detach(), [torch.zeros_like(p) if g is None else g
                                   for p, g in zip(params, grads)]

        n = parallel.grad_accum
        if n > 1:
            bsz = batch["tokens"].shape[0]
            if bsz % n:
                raise ValueError(f"batch {bsz} does not split into "
                                 f"{n} micro-batches")
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in params]
            losses = []
            for i in range(n):
                sl = slice(i * bsz // n, (i + 1) * bsz // n)
                loss, g = value_and_grad({k: v[sl] for k, v in batch.items()})
                for acc, gi in zip(grads, g):
                    acc.add_(gi.to(torch.float32) / n)
                losses.append(loss)
                del g
            loss = torch.stack(losses).mean()
        else:
            loss, grads = value_and_grad(batch)
        if sh is not None:
            loss = sh.total(loss)
        new_params, new_opt, om = adamw.update(dict(zip(names, grads)), opt,
                                               tc)
        del grads
        for name, p in zip(names, params):
            if sh is None:
                p.data = new_params[name]
            else:                   # a DTensor's .data is not its shard
                owner, _, leaf = name.rpartition(".")
                mod = model.get_submodule(owner) if owner else model
                mod._parameters[leaf] = torch.nn.Parameter(
                    new_params[name], requires_grad=p.requires_grad)
        return {"model": model, "opt": new_opt}, {"loss": loss, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig,
                      parallel: Optional[ParallelConfig] = None,
                      constraint=None):
    """``parallel`` is taken for the reference's signature: the prefill
    runs with remat off whatever it says.  With ``constraint`` carrying a
    mesh and ``seq_shard``, the MoE layers run sharded over it."""
    def last_logits(model: M.Model, batch: Dict, con) -> torch.Tensor:
        # inference forward: remat off (no backward pass to feed)
        hidden = M.forward(cfg, model, batch, remat=False,
                           constraint=con, return_hidden=True)
        return L.matmul(hidden[:, -1, :], M.lm_head(cfg, model))

    @torch.no_grad()
    def prefill_step(model: M.Model, batch: Dict) -> torch.Tensor:
        """batch["tokens"] [B, S] (with ``frames`` or ``vision_embeds``
        as ``forward`` takes them) -> next-token logits [B, V]; on DTensor
        parameters a DTensor of the rows each rank computed."""
        sh = _Shards.of(cfg, model, batch["tokens"], constraint)
        if sh is None:
            return last_logits(model, batch, constraint)
        with sh.swapped(model, False):
            return sh.wrap(last_logits(model, sh.rows(batch),
                                       sh.constraint))
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    @torch.no_grad()
    def serve_step(model: M.Model, token: torch.Tensor,
                   cache_len: torch.Tensor, caches: Dict[str, torch.Tensor]):
        """token [B, 1], cache_len [B] -> (next token int32 [B, 1], logits
        [B, 1, V], new caches).  On DTensor parameters and caches each
        rank decodes its rows against its rows of the caches (gathered
        over the dims the caches' specs split otherwise), and the new
        caches go back to their placements."""
        sh = _Shards.of(cfg, model, token, None)
        if sh is None:
            logits, caches = M.decode_step(cfg, model, token, cache_len,
                                           caches)
            next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            return next_tok[:, None], logits, caches
        placed = {k: v.placements for k, v in caches.items()}
        local = sh.rows(caches, dim=1)
        io = sh.rows({"token": token, "cache_len": cache_len})
        with sh.swapped(model, False):
            logits, local = M.decode_step(cfg, model, io["token"],
                                          io["cache_len"], local)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        caches = {k: sh.wrap(v, 1).redistribute(sh.mesh, placed[k])
                  for k, v in local.items()}
        return sh.wrap(next_tok[:, None]), sh.wrap(logits), caches
    return serve_step


def init_state(cfg: ModelConfig, seed: int = 0, device="cuda",
               dtype: torch.dtype = L.DTYPE, shardings=None) -> Dict:
    """A model with random weights (``init_model``) and its optimizer
    state (fp32 masters of its parameters, zero moments).  With
    ``shardings`` = (mesh, ``sharding.state_specs``' tree), every rank
    draws the same model, distributes it under the tree's parameter
    specs, and builds the optimizer's leaves from the shards (the state
    specs' layout: master, mu and nu mirror the parameters, the step
    replicated), so the whole optimizer state never exists on a rank."""
    model = M.init_model(cfg, seed=seed, device=device, dtype=dtype)
    if shardings is not None:
        mesh, specs = shardings
        SH.distribute(model, mesh, specs["model"])
    return {"model": model, "opt": adamw.init(dict(model.named_parameters()))}


def state_shapes(cfg: ModelConfig) -> Dict:
    """A fresh state's structure, shapes and dtypes on the meta device
    (bf16 parameters, fp32 ``A_log`` and ``D``, fp32 optimizer leaves, an
    int32 step): what ``checkpoint.restore`` casts each leaf to."""
    model = M.param_shapes(cfg)
    return {"model": model, "opt": adamw.init(dict(model.named_parameters()))}
