"""Launch the CUDA fused selective scan kernel (``csrc/selective_scan.cu``,
built and bound by ``selective_scan.py``), which forms dt * x * B itself.

The wrapper takes CUDA fp32 contiguous tensors only, checks their shapes,
allocates the output with ``torch.empty``, launches on the current stream
without synchronising, and raises if the launch was refused.
``launches`` counts its kernel launches.
"""
from __future__ import annotations

from typing import Dict

import torch

from .. import _build
from .selective_scan import check_args, load, scan_dims

launches: Dict[str, int] = {"selective_scan_fused": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def selective_scan_fused(dt: torch.Tensor, x: torch.Tensor,
                         bm: torch.Tensor, c: torch.Tensor,
                         a: torch.Tensor) -> torch.Tensor:
    """dt/x: [B, T, di]; bm/c: [B, T, N]; a: [di, N] (fp32, any T and di)
    -> y [B, T, di] fp32, on the card."""
    b, t, di, n = scan_dims(dt, a)
    check_args("selective_scan_fused",
               [("dt", dt), ("x", x), ("bm", bm), ("c", c), ("a", a)],
               {"dt": (b, t, di), "x": (b, t, di), "bm": (b, t, n),
                "c": (b, t, n), "a": (di, n)})
    y = torch.empty_like(dt)
    if y.numel() == 0:
        return y
    lib = load()
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = lib.selective_scan_fused(
            dt.data_ptr(), x.data_ptr(), bm.data_ptr(), c.data_ptr(),
            a.data_ptr(), y.data_ptr(), b, t, di, n, stream)
    _build.raise_on(err, "selective_scan_fused")
    launches["selective_scan_fused"] += 1
    return y
