"""Training steps of the reference: the loss of ``model.loss`` and
AdamW as the configuration states it, all in float32.

AdamW: the gradients clipped to a global norm of ``grad_clip`` (scale
min(1, clip / (norm + 1e-9))), moments with ``beta1``/``beta2``, bias
corrections 1 - beta^t, eps 1e-8, decoupled weight decay on every leaf,
``p -= lr (m_hat / (sqrt(v_hat) + eps) + wd p)``; the learning rate a
linear warm-up over ``warmup_steps`` to ``learning_rate`` and then a
cosine to 0 at ``total_steps``, read at the step's number (1 for the
first)."""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import model as R


def learning_rate(opt: Dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    return opt["learning_rate"] * warm * 0.5 * (1 + math.cos(math.pi * prog))


def readings(cfg: Dict, weights: Dict[str, torch.Tensor],
             batches: List[Dict[str, torch.Tensor]], opt: Dict,
             precision: str = "fp32") -> Dict:
    """Train from ``weights`` on ``batches`` in turn -> {"grad": each
    leaf's norm of the first step's clipped gradient, "change": each
    leaf's norm of its change over the steps}."""
    params = {n: w.to(torch.float32).clone().requires_grad_(True)
              for n, w in weights.items()}
    names = list(params)
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2, eps = opt["beta1"], opt["beta2"], 1e-8
    first = None
    for k, batch in enumerate(batches, start=1):
        loss = R.loss(params, cfg, batch["tokens"], batch["targets"],
                      precision)
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, grads)]
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp(opt["grad_clip"] / (norm + 1e-9), max=1.0)
            if first is None:
                first = {n: float(torch.linalg.vector_norm(g) * scale)
                         for n, g in zip(names, grads)}
            lr = learning_rate(opt, k)
            for n, g in zip(names, grads):
                p, m, v = params[n], mu[n], nu[n]
                g = g * scale
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                mhat = m / (1 - b1 ** k)
                vhat = v / (1 - b2 ** k)
                p.sub_(lr * (mhat / (torch.sqrt(vhat) + eps)
                             + opt["weight_decay"] * p))
        del grads, loss
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(
            params[n] - weights[n].to(torch.float32))) for n in names}
    return {"grad": first, "change": change}
