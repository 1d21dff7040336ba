"""Public flash attention: the kernel for CUDA tensors, the plain version
for CPU tensors, differentiable on both.

The choice follows only the device of q: CUDA tensors launch the CUDA
kernel (which raises on anything it does not take), CPU tensors take the
plain PyTorch version in ``ref``.  Nothing falls back from one to the
other.

``flash_attention`` is an autograd ``Function``, the reference's custom
VJP (``_fwd``/``_bwd`` of its ``ops.py``); no softmax weights are stored
between the passes.  On CUDA tensors that need a gradient the forward
also asks the kernel for each row's log-sum-exp and saves (q, k, v, out,
lse), and the backward launches the backward kernels
(``kernel.flash_attention_bwd``) and nothing else; a forward that needs
no gradient (inference) writes no log-sum-exp.  On CPU tensors the
forward saves (q, k, v) and the backward recomputes attention through
the dense ``attention_ref`` under autograd, the reference's own form.
The kernel wrapper itself refuses inputs that require a gradient under
grad mode, so no path reaches it without this backward.
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
    backward through the backward kernels (or by recomputing
    ``attention_ref`` on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        ctx.causal, ctx.window = causal, window
        if q.device.type == "cuda" and any(ctx.needs_input_grad[:3]):
            out, lse = kernel.flash_attention_fwd(
                q, k, v, causal=causal, window=window, with_lse=True)
            ctx.save_for_backward(q, k, v, out, lse)
            return out
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors      # once: checkpoint unpacks it once
        if saved[0].device.type == "cuda":
            q, k, v, out, lse = saved
            dq, dk, dv = kernel.flash_attention_bwd(
                q, k, v, out, lse, grad, causal=ctx.causal,
                window=ctx.window)
            return dq, dk, dv, None, None
        q, k, v = saved
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
