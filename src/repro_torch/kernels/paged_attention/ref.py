"""Plain PyTorch paged decode attention: gather the pages, dense attention.

The same function as the CUDA kernel in ``csrc/paged_attention.cu`` (and
the reference's ``paged_attention_ref``); the entry point takes it for CPU
tensors, and the card run compares the kernel with it.
"""
from __future__ import annotations

import math

import torch


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        context_lens: torch.Tensor) -> torch.Tensor:
    """q: [B, H, D]; pages [P, ps, KV, D]; tables int32 [B, MP]; lens
    int32 [B] (index of the newest valid token) -> [B, H, D] in q's dtype,
    softmax in fp32.  Any group G = H / KV, as the kernel (which takes a
    group past its 16 rows a block in chunks) and the reference do."""
    bsz, h, d = q.shape
    _, ps, kvh, _ = k_pages.shape
    mp = block_tables.shape[1]
    g = h // kvh
    idx = block_tables.long()
    k = k_pages[idx].reshape(bsz, mp * ps, kvh, d)
    v = v_pages[idx].reshape(bsz, mp * ps, kvh, d)
    qr = q.reshape(bsz, kvh, g, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qr.float(), k.float()) / math.sqrt(d)
    pos = torch.arange(mp * ps, device=q.device)[None, None, None, :]
    s = torch.where(pos <= context_lens.long()[:, None, None, None], s,
                    torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return out.reshape(bsz, h, d).to(q.dtype)
