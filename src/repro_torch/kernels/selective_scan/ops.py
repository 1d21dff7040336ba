"""Public selective scans: the kernels for CUDA tensors, the plain versions
for CPU tensors.

The choice follows only the device of dt: CUDA tensors launch the CUDA
kernels (which raise on anything they do not take), CPU tensors take the
plain PyTorch versions in ``ref``.  Nothing falls back from one to the
other.  ``mamba_scan`` is the reference's public name for v1; the model's
prefill calls ``selective_scan_fused``.
"""
from __future__ import annotations

import torch

from . import fused
from . import selective_scan as kernel
from .ref import selective_scan_fused_ref, selective_scan_ref


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


def selective_scan_fused(dt: torch.Tensor, x: torch.Tensor,
                         bm: torch.Tensor, c: torch.Tensor,
                         a: torch.Tensor) -> torch.Tensor:
    """dt/x: [B, T, di]; bm/c: [B, T, N]; a: [di, N] (fp32) -> y
    [B, T, di] fp32."""
    if _route(dt) == "cuda":
        return fused.selective_scan_fused(dt, x, bm, c, a)
    return selective_scan_fused_ref(dt, x, bm, c, a)
