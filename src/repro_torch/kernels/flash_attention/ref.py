"""Plain PyTorch attention (dense softmax), the flash kernels' functions.

``attention_ref`` is the same function as the forward CUDA kernel in
``csrc/flash_attention.cu`` (and the reference's ``attention_ref``); the
entry point takes it for CPU tensors, and the card run compares the
kernel with it.  ``attention_bwd_ref`` is the backward kernels'
function, its gradients written out (not autograd through the forward):
the tests hold it against ``jax.grad`` of the reference's flash
attention, and the card run holds the backward kernels against it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def _mask(sq: int, skv: int, causal: bool, window: Optional[int],
          device) -> torch.Tensor:
    """[Sq, Skv]: True where the key at position kp is visible to the
    query at position qp: always, or kp <= qp if causal, and kp > qp -
    window with a window."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q: [B, H, Sq, D]; k/v: [B, KV, Skv, D] -> [B, H, Sq, D] in q's
    dtype, softmax in fp32."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    qr = q.reshape(b, kvh, g, sq, d)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qr.float(),
                          k.float()) / math.sqrt(d)
    mask = _mask(sq, skv, causal, window, q.device)
    scores = torch.where(mask, scores, torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(b, h, sq, d).to(q.dtype)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, dout: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None):
    """The gradients of ``attention_ref`` at dout: q/out/dout [B, H, Sq,
    D]; k/v [B, KV, Skv, D] -> (dq, dk, dv) in the inputs' dtypes, in
    fp32 inside:

        P  = softmax(Q K^T / sqrt(D)), masked scores at -1e30
        dV = P^T dO        D_i = sum_d dO_id O_id
        dS = P (dO V^T - D_i) where the key is visible, else 0
        dQ = dS K / sqrt(D)           dK = dS^T Q / sqrt(D)

    dk and dv summed over the G query heads of each KV head.  A row that
    sees no key has the uniform P = 1 / Skv of the -1e30 fill, so it adds
    dO / Skv to every key's dv and nothing to dq or dk (the fill is a
    constant)."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    qf, of, dof = (t.reshape(b, kvh, g, sq, d).float()
                   for t in (q, out, dout))
    kf, vf = k.float(), v.float()
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) / math.sqrt(d)
    mask = _mask(sq, skv, causal, window, q.device)
    scores = torch.where(mask, scores, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(scores, dim=-1)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
    delta = (dof * of).sum(-1, keepdim=True)
    ds = torch.where(mask, p * (dp - delta), torch.zeros((), device=q.device))
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * scale
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
