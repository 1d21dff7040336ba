"""Plain PyTorch selective scans, the kernels' functions.

The same functions as the CUDA kernels in ``csrc/selective_scan.cu`` (and
the reference's ``selective_scan_ref``): the sequential recurrence in
fp32.  The entry points take them for CPU tensors, and the card run
compares the kernels with them.
"""
from __future__ import annotations

import torch


def selective_scan_ref(dt: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                       a: torch.Tensor) -> torch.Tensor:
    """dt: [B, T, di]; bx: [B, T, di, N]; c: [B, T, N]; a: [di, N] (all
    fp32) -> y [B, T, di] fp32, with h_t = exp(dt_t * a) * h_{t-1} + bx_t,
    h_0 = 0 and y_t = sum_n h_t * c_t."""
    b, t, di = dt.shape
    h = torch.zeros((b, di, a.shape[-1]), dtype=torch.float32,
                    device=dt.device)
    ys = []
    for i in range(t):
        h = h * torch.exp(dt[:, i, :, None] * a) + bx[:, i]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, i]))
    return torch.stack(ys, 1) if ys else dt.new_zeros((b, 0, di))


def selective_scan_fused_ref(dt: torch.Tensor, x: torch.Tensor,
                             bm: torch.Tensor, c: torch.Tensor,
                             a: torch.Tensor) -> torch.Tensor:
    """dt/x: [B, T, di]; bm/c: [B, T, N]; a: [di, N] (all fp32) -> y
    [B, T, di] fp32: ``selective_scan_ref`` with bx = (dt * x) * B, in the
    order the reference's fused kernel forms it."""
    bx = (dt * x)[..., None] * bm[:, :, None, :]
    return selective_scan_ref(dt, bx, c, a)
