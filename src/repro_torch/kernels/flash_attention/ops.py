"""Public flash attention (forward only): the kernel for CUDA tensors, the
plain version for CPU tensors.

The choice follows only the device of q: CUDA tensors launch the CUDA
kernel (which raises on anything it does not take), CPU tensors take the
plain PyTorch version in ``ref``.  Nothing falls back from one to the
other.  Serving needs no gradient; the reference's recompute backward
comes with the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import flash_attention as kernel
from .ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: [B, H, S, D]; k/v: [B, KV, S, D] -> [B, H, S, D]."""
    if q.device.type == "cuda":
        return kernel.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window)
    if q.device.type != "cpu":
        raise ValueError(f"no flash attention for tensors on {q.device}")
    return attention_ref(q, k, v, causal=causal, window=window)
