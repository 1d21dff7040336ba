"""Public flash attention: the kernel for CUDA tensors, the plain version
for CPU tensors, differentiable on both.

The choice follows only the device of q: CUDA tensors launch the CUDA
kernel (which raises on anything it does not take), CPU tensors take the
plain PyTorch version in ``ref``.  Nothing falls back from one to the
other.

``flash_attention`` is an autograd ``Function``, the reference's custom
VJP (``_fwd``/``_bwd`` of its ``ops.py``): the forward saves only (q, k,
v), and the backward recomputes attention through the dense
``attention_ref`` under autograd and returns its gradients, so no
softmax weights are stored between the passes.  The kernel wrapper itself
refuses inputs that require a gradient under grad mode, so no path
reaches it without this backward.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import flash_attention as kernel
from .ref import attention_ref


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, window: Optional[int]) -> torch.Tensor:
    if q.device.type == "cuda":
        return kernel.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window)
    if q.device.type != "cpu":
        raise ValueError(f"no flash attention for tensors on {q.device}")
    return attention_ref(q, k, v, causal=causal, window=window)


class FlashAttention(torch.autograd.Function):
    """Forward through the kernel (or the plain version on the CPU);
    backward by recomputing ``attention_ref``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attention_ref(*qkv, causal=ctx.causal, window=ctx.window)
            dq, dk, dv = torch.autograd.grad(out, qkv, grad)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: [B, H, S, D]; k/v: [B, KV, S, D] -> [B, H, S, D]."""
    return FlashAttention.apply(q, k, v, causal, window)
