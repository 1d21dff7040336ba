"""Build and launch the CUDA flash attention forward kernel
(``csrc/flash_attention.cu``).

The source is compiled at first use with nvcc into a shared library and
bound with ctypes (``kernels/_build.py``).  The wrapper takes CUDA tensors
only, checks device, dtype, contiguity and shapes, refuses inputs that
require a gradient under grad mode (``ops.flash_attention`` is the
differentiable entry point), allocates the output with ``torch.empty``, launches on the current stream without
synchronising, and raises if the launch was refused.  ``launches`` counts
its kernel launches, ``variant_launches`` the same launches by kernel.

The source holds two kernels, and ``variant`` picks one from the inputs'
dtype, head dim and alignment before the launch: ``"mma"``, bf16 on the
tensor cores, for bf16 with D a multiple of 16 up to 256 and 16-byte
aligned tensors; ``"simt"``, fp32 arithmetic on the CUDA cores (no TF32),
for fp32 and any other bf16 call.  Both fold a KV head's G query heads
into the rows of one problem, so any G fits; ``supports`` says which head
counts the kernels take, and the wrapper raises on exactly the others.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from .. import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_VP, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"flash_attention_fwd": [_VP] * 4 + [_I] * 9 + [_VP],
              "flash_attention_fwd_bf16_wgmma": [_VP] * 4 + [_I] * 8 + [_VP]}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_GRID_YZ = 65535     # CUDA's limit on a grid's y and z extents

launches: Dict[str, int] = {"flash_attention": 0}
variant_launches: Dict[str, int] = {"mma": 0, "simt": 0}


def reset_launches() -> None:
    for counts in (launches, variant_launches):
        for name in counts:
            counts[name] = 0


def supports(h: int, kvh: int, d: int) -> bool:
    """Whether the kernels take ``h`` query heads of head dim ``d`` on
    ``kvh`` KV heads: any group (H % KV == 0), at most MAX_GRID_YZ KV
    heads (the grid's y extent) and 1 <= D <= MAX_HEAD_DIM."""
    return (1 <= kvh <= min(h, MAX_GRID_YZ) and h % kvh == 0
            and 1 <= d <= MAX_HEAD_DIM)


def variant(dtype: torch.dtype, d: int, aligned: bool = True) -> str:
    """The kernel a call of head dim ``d`` takes: "mma" (bf16 on the
    tensor cores) for bf16 with D a multiple of 16 up to 256 when every
    tensor is 16-byte aligned, else "simt" (fp32 on the CUDA cores)."""
    if dtype == torch.bfloat16 and d % 16 == 0 and 16 <= d <= MAX_HEAD_DIM \
            and aligned:
        return "mma"
    return "simt"


def load() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its signature."""
    return _build.load(SOURCE, SIGNATURES)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Attention forward on the card.  q: [B, H, Sq, D]; k/v: [B, KV, Skv,
    D] (fp32 or bf16, all three alike; any Sq and Skv) -> [B, H, Sq, D] in
    q's dtype."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("flash_attention_fwd launches a CUDA kernel; "
                         f"got tensors on {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype of "
                        f"{list(DTYPES)}; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, h, sq, d = q.shape
    bk, kvh, skv, dk = k.shape
    if bk != b or dk != d or not supports(h, kvh, d) or skv < 1 \
            or b > MAX_GRID_YZ:
        raise ValueError(f"q {tuple(q.shape)} against k {tuple(k.shape)}: "
                         f"needs one batch of at most {MAX_GRID_YZ}, "
                         f"H % KV == 0, KV <= {MAX_GRID_YZ}, D <= "
                         f"{MAX_HEAD_DIM} and at least one key")
    if window is not None and window < 1:
        raise ValueError(f"window={window}: needs None or >= 1")
    _build.refuse_grad("flash_attention_fwd", "ops.flash_attention", q, k, v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    kind = variant(q.dtype, d, all(t.data_ptr() % 16 == 0
                                   for t in (q, k, v, out)))
    launch(kind, q, k, v, out, causal, window)
    launches["flash_attention"] += 1
    variant_launches[kind] += 1
    return out


def launch(kind: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, causal: bool, window: Optional[int]) -> None:
    """Launch kernel ``kind`` on inputs the wrapper has checked (and
    ``variant`` allows for "mma"); counts nothing."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    lib = load()
    win = 0 if window is None else int(window)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kind == "mma":
            err = lib.flash_attention_fwd_bf16_wgmma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                h, kvh, sq, skv, d, int(causal), win, stream)
        else:
            err = lib.flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                DTYPES[q.dtype], b, h, kvh, sq, skv, d, int(causal), win,
                stream)
    _build.raise_on(err, f"flash_attention_fwd ({kind})")
