"""Public paged decode attention: the kernel for CUDA tensors, the plain
version for CPU tensors.

The choice follows only the device of the KV pages: CUDA pages launch the
CUDA kernel (which raises on anything it does not take), CPU pages take
the plain PyTorch version in ``ref``.  Nothing falls back from one to the
other.
"""
from __future__ import annotations

import torch

from . import paged_attention as kernel
from .ref import paged_attention_ref


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    context_lens: torch.Tensor) -> torch.Tensor:
    """q: [B, H, D]; pages [P, page_size, KV, D]; block_tables int32
    [B, max_pages]; context_lens int32 [B] (inclusive) -> [B, H, D]."""
    if k_pages.device.type == "cuda":
        return kernel.paged_attention_decode(q, k_pages, v_pages,
                                             block_tables, context_lens)
    if k_pages.device.type != "cpu":
        raise ValueError(f"no paged attention for tensors on "
                         f"{k_pages.device}")
    return paged_attention_ref(q, k_pages, v_pages, block_tables,
                               context_lens)
