"""Build and launch the CUDA selective scan v1 kernel
(``csrc/selective_scan.cu``, which also holds the fused kernel that
``fused.py`` launches).

The source is compiled at first use with nvcc into a shared library and
bound with ctypes (``kernels/_build.py``).  The wrapper takes CUDA fp32
contiguous tensors only, checks their shapes, allocates the output with
``torch.empty``, launches on the current stream without synchronising,
and raises if the launch was refused.  ``launches`` counts its kernel
launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

from .. import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan.cu"
_VP, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"selective_scan": [_VP] * 5 + [_I] * 4 + [_VP],
              "selective_scan_fused": [_VP] * 6 + [_I] * 5 + [_VP]}
MAX_STATE = 16          # N the kernels hold: 16 states a channel
MAX_BATCH = 65535       # the grid's y dimension

launches: Dict[str, int] = {"selective_scan": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def load() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its
    signatures."""
    return _build.load(SOURCE, SIGNATURES)


def check_args(name: str, tensors: Sequence[Tuple[str, torch.Tensor]],
               shapes: Dict[str, tuple]) -> None:
    """Raise unless every tensor is a contiguous fp32 CUDA tensor on one
    device with the shape ``shapes`` gives it."""
    dev = tensors[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"{name} launches a CUDA kernel; got tensors on "
                         f"{dev}")
    for arg, t in tensors:
        if t.device != dev:
            raise ValueError(f"{arg} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{arg} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
        if tuple(t.shape) != shapes[arg]:
            raise ValueError(f"{arg} has shape {tuple(t.shape)}, expected "
                             f"{shapes[arg]}")


def scan_dims(dt: torch.Tensor, a: torch.Tensor) -> Tuple[int, int, int, int]:
    """(B, T, di, N) from dt [B, T, di] and a [di, N], checked against what
    the kernels take."""
    if dt.dim() != 3 or a.dim() != 2:
        raise ValueError(f"dt {tuple(dt.shape)} must be [B, T, di] and a "
                         f"{tuple(a.shape)} [di, N]")
    (b, t, di), n = dt.shape, a.shape[1]
    if not 1 <= n <= MAX_STATE or b > MAX_BATCH:
        raise ValueError(f"N = {n} and B = {b}: the kernels take "
                         f"1 <= N <= {MAX_STATE} and B <= {MAX_BATCH}")
    return b, t, di, n


def selective_scan(dt: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                   a: torch.Tensor) -> torch.Tensor:
    """dt: [B, T, di]; bx: [B, T, di, N]; c: [B, T, N]; a: [di, N] (fp32,
    any T and di) -> y [B, T, di] fp32, on the card."""
    b, t, di, n = scan_dims(dt, a)
    check_args("selective_scan",
               [("dt", dt), ("bx", bx), ("c", c), ("a", a)],
               {"dt": (b, t, di), "bx": (b, t, di, n), "c": (b, t, n),
                "a": (di, n)})
    y = torch.empty_like(dt)
    if y.numel() == 0:
        return y
    lib = load()
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = lib.selective_scan(dt.data_ptr(), bx.data_ptr(), c.data_ptr(),
                                 a.data_ptr(), y.data_ptr(), b, t, di, n,
                                 stream)
    _build.raise_on(err, "selective_scan")
    launches["selective_scan"] += 1
    return y
