"""Plain PyTorch selective scans, the kernels' functions.

The same functions as the CUDA kernels in ``csrc/selective_scan.cu`` (and
the reference's ``selective_scan_ref``): the sequential recurrence in
fp32.  The entry points take them for CPU tensors, and the card run
compares the kernels with them.

``ssm_scan_chunked`` is the same function in the form the reference
trains through (its ``models/layers.py::_ssm_scan_chunked``): chunks of
the sequence in turn, each under activation checkpointing, and inside a
chunk an associative scan in log2(chunk) shifted combine steps.  It is the
fused scan's backward (``ops.selective_scan_fused``); autograd never runs
through the T-step loop of the sequential versions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

CHUNK = 128             # steps a chunk, the reference's Mamba default


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


def _chunk_scan(h0: torch.Tensor, dt: torch.Tensor, x: torch.Tensor,
                bm: torch.Tensor, c: torch.Tensor, a: torch.Tensor):
    """One chunk of L steps from the state h0 [B, di, N]: (the state
    after its last step, y [B, L, di]).  The pairs (decay_t, bx_t) are
    combined by (dl, xl) . (dr, xr) = (dl dr, xl dr + xr), the earlier
    on the left, in log2(L) shifted steps (an inclusive Hillis-Steele
    scan, each step out of place: the counterpart of
    ``jax.lax.associative_scan``); then the carry is folded in.  A step
    combines each position with the one ``shift`` before it, read from a
    copy shifted by padding (identity pairs (1, 0) shifted in), so
    positions before ``shift`` keep their pair and no step slices a
    tensor twice (the backward of a shift is one shift back)."""
    decay = torch.exp(dt[..., None] * a)                    # [B, L, di, N]
    h = (dt * x)[..., None] * bm[:, :, None, :]             # bx
    d, shift = decay, 1
    while shift < dt.shape[1]:
        back = (0, 0, 0, 0, shift, -shift)     # along L: pad front, crop end
        h = torch.addcmul(h, F.pad(h, back), d)             # xl dr + xr
        d = F.pad(d, back, value=1.0) * d                   # dl dr
        shift *= 2
    hs = torch.addcmul(h, d, h0[:, None])
    return hs[:, -1], torch.einsum("bldn,bln->bld", hs, c)


def ssm_scan_chunked(dt: torch.Tensor, x: torch.Tensor, bm: torch.Tensor,
                     c: torch.Tensor, a: torch.Tensor,
                     chunk: int = CHUNK) -> torch.Tensor:
    """``selective_scan_fused_ref``'s function (dt/x [B, T, di]; bm/c
    [B, T, N]; a [di, N], fp32 -> y [B, T, di]) over chunks of ``chunk``
    steps (the last one shorter when T is not a multiple), bx = (dt * x)
    * B formed a chunk at a time, never for the whole [B, T, di, N].
    Under grad mode each chunk runs under ``torch.utils.checkpoint``: only
    the carried states are kept between the passes, and the backward
    recomputes one chunk at a time."""
    b, t, di = dt.shape
    h = dt.new_zeros((b, di, a.shape[-1]))
    ys = []
    for s in range(0, t, chunk):
        args = (h, dt[:, s:s + chunk], x[:, s:s + chunk],
                bm[:, s:s + chunk], c[:, s:s + chunk], a)
        if torch.is_grad_enabled():
            h, y = checkpoint(_chunk_scan, *args, use_reentrant=False)
        else:
            h, y = _chunk_scan(*args)
        ys.append(y)
    return torch.cat(ys, 1) if ys else dt.new_zeros((b, 0, di))
