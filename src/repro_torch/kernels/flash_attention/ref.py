"""Plain PyTorch attention (dense softmax), the flash kernel's function.

The same function as the CUDA kernel in ``csrc/flash_attention.cu`` (and
the reference's ``attention_ref``); the entry point takes it for CPU
tensors, and the card run compares the kernel with it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


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
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(b, h, sq, d).to(q.dtype)
