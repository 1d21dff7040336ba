"""Public selective scans: the kernels for CUDA tensors, the plain versions
for CPU tensors.

The choice follows only the device of dt: CUDA tensors launch the CUDA
kernels (which raise on anything they do not take), CPU tensors take the
plain PyTorch versions in ``ref``.  Nothing falls back from one to the
other.  ``mamba_scan`` is the reference's public name for v1; the model's
prefill calls ``selective_scan_fused``.

``selective_scan_fused`` is an autograd ``Function``: the forward runs
the fused kernel (or the sequential plain version on the CPU) and saves
its inputs; the backward returns the gradients of dt, x, B, C and A.  On
CUDA tensors it launches the backward kernel
(``fused.selective_scan_fused_bwd``) and nothing else; on CPU tensors it
recomputes the scan through ``ssm_scan_chunked`` (the reference's
training scan: checkpointed chunks, an associative scan inside each)
under autograd.  The kernel wrappers themselves refuse inputs that
require a gradient under grad mode, so no path reaches the forward
kernel without this backward.
"""
from __future__ import annotations

import torch

from . import fused
from . import selective_scan as kernel
from .ref import selective_scan_fused_ref, selective_scan_ref, ssm_scan_chunked


def _route(dt: torch.Tensor) -> str:
    if dt.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no selective scan for tensors on {dt.device}")
    return dt.device.type


def mamba_scan(dt: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
               a: torch.Tensor) -> torch.Tensor:
    """dt: [B, T, di]; bx: [B, T, di, N]; c: [B, T, N]; a: [di, N] (fp32)
    -> y [B, T, di] fp32."""
    if _route(dt) == "cuda":
        return kernel.selective_scan(dt, bx, c, a)
    return selective_scan_ref(dt, bx, c, a)


class SelectiveScanFused(torch.autograd.Function):
    """Forward through the fused kernel (or the plain version on the
    CPU); backward through the backward kernel (or the chunked scan on
    the CPU)."""

    @staticmethod
    def forward(ctx, dt, x, bm, c, a):
        ctx.save_for_backward(dt, x, bm, c, a)
        if _route(dt) == "cuda":
            return fused.selective_scan_fused(dt, x, bm, c, a)
        return selective_scan_fused_ref(dt, x, bm, c, a)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors      # once: checkpoint unpacks it once
        if _route(saved[0]) == "cuda":
            return fused.selective_scan_fused_bwd(*saved, grad.contiguous())
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in saved]
            y = ssm_scan_chunked(*inputs)
            return torch.autograd.grad(y, inputs, grad)


def selective_scan_fused(dt: torch.Tensor, x: torch.Tensor,
                         bm: torch.Tensor, c: torch.Tensor,
                         a: torch.Tensor) -> torch.Tensor:
    """dt/x: [B, T, di]; bm/c: [B, T, N]; a: [di, N] (fp32) -> y
    [B, T, di] fp32."""
    return SelectiveScanFused.apply(dt, x, bm, c, a)
