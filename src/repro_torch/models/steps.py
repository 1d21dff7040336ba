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
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

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


def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    parallel: ParallelConfig, constraint=None):
    loss_fn = make_loss_fn(cfg, parallel, constraint)

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        """batch: ``tokens``/``targets`` int [B, S] on the model's device
        (and an encdec model's ``frames``, a vlm's ``vision_embeds``; a
        micro-batch slices every key on its first dim) -> (the state,
        updated in place; metrics ``loss``, ``grad_norm``, ``lr`` as
        0-dim fp32 tensors, read nowhere in the step)."""
        model, opt = state["model"], state["opt"]
        names, params = zip(*model.named_parameters())

        def value_and_grad(mb):
            loss = loss_fn(model, mb)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            return loss.detach(), [torch.zeros_like(p) if g is None else g
                                   for p, g in zip(params, grads)]

        n = parallel.grad_accum
        if n > 1:
            bsz = batch["tokens"].shape[0]
            if bsz % n:
                raise ValueError(f"batch {bsz} does not split into "
                                 f"{n} micro-batches")
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in params]
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
        new_params, new_opt, om = adamw.update(dict(zip(names, grads)), opt,
                                               tc)
        del grads
        for name, p in zip(names, params):
            p.data = new_params[name]
        return {"model": model, "opt": new_opt}, {"loss": loss, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig,
                      parallel: Optional[ParallelConfig] = None,
                      constraint=None):
    """``parallel`` is taken for the reference's signature: the prefill
    runs with remat off whatever it says.  With ``constraint`` carrying a
    mesh and ``seq_shard``, the MoE layers run sharded over it."""
    @torch.no_grad()
    def prefill_step(model: M.Model, batch: Dict) -> torch.Tensor:
        """batch["tokens"] [B, S] (with ``frames`` or ``vision_embeds``
        as ``forward`` takes them) -> next-token logits [B, V]."""
        # inference forward: remat off (no backward pass to feed)
        hidden = M.forward(cfg, model, batch, remat=False,
                           constraint=constraint, return_hidden=True)
        return L.matmul(hidden[:, -1, :], M.lm_head(cfg, model))
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    @torch.no_grad()
    def serve_step(model: M.Model, token: torch.Tensor,
                   cache_len: torch.Tensor, caches: Dict[str, torch.Tensor]):
        """token [B, 1], cache_len [B] -> (next token int32 [B, 1], logits
        [B, 1, V], new caches)."""
        logits, caches = M.decode_step(cfg, model, token, cache_len, caches)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], logits, caches
    return serve_step


def init_state(cfg: ModelConfig, seed: int = 0, device="cuda",
               dtype: torch.dtype = L.DTYPE) -> Dict:
    """A model with random weights (``init_model``) and its optimizer
    state (fp32 masters of its parameters, zero moments)."""
    model = M.init_model(cfg, seed=seed, device=device, dtype=dtype)
    return {"model": model, "opt": adamw.init(dict(model.named_parameters()))}


def state_shapes(cfg: ModelConfig) -> Dict:
    """A fresh state's structure, shapes and dtypes on the meta device
    (bf16 parameters, fp32 ``A_log`` and ``D``, fp32 optimizer leaves, an
    int32 step): what ``checkpoint.restore`` casts each leaf to."""
    model = M.param_shapes(cfg)
    return {"model": model, "opt": adamw.init(dict(model.named_parameters()))}
