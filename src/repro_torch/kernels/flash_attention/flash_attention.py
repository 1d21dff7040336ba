"""Build and launch the CUDA flash attention kernels, forward and backward
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
With ``with_lse`` the forward also returns each row's log-sum-exp (fp32
[B, H, Sq]), which the backward takes; without it the kernels write none.

``flash_attention_bwd`` launches the backward: a dQ kernel (which also
writes each row's Delta = sum_d dO O into a scratch) then a dK/dV kernel,
each owning its output rows (no atomics: deterministic).  ``bwd_variant``
picks the tensor cores (``"mma"``: bf16, D a multiple of 16 up to 128,
every pointer and row 16-byte aligned; wgmma fed by TMA, the scratch
[2, B, H, Sq rounded up to ``BWD_ROW_TILE``] holding Delta and the
log-sum-exp in log2 units) or the CUDA cores (``"simt"``: fp32, or any
other bf16 call; the scratch [B, H, Sq]); ``supports`` guards both
directions.  A window row that sees no key gets, as in the reference, the
mean of v from the forward and dO / Skv in every key's dv.  ``launches`` counts one
launch a wrapper call (the backward's two kernels count once) and
``bwd_variant_launches`` the backward's by variant.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from .. import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_VP, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"flash_attention_fwd": [_VP] * 5 + [_I] * 9 + [_VP],
              "flash_attention_fwd_bf16_wgmma": [_VP] * 5 + [_I] * 8 + [_VP],
              "flash_attention_bwd": ([_VP] * 10 + [_I] * 10
                                      + [ctypes.c_longlong] * 3 + [_VP])}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_MMA_BWD_HEAD_DIM = 128  # the tensor-core backward's widest D
BWD_ROW_TILE = 64           # the tensor-core backward's positions a tile
MAX_GRID_YZ = 65535     # CUDA's limit on a grid's y and z extents

launches: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0}
variant_launches: Dict[str, int] = {"mma": 0, "simt": 0}
bwd_variant_launches: Dict[str, int] = {"mma": 0, "simt": 0}


def reset_launches() -> None:
    for counts in (launches, variant_launches, bwd_variant_launches):
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


def bwd_variant(dtype: torch.dtype, d: int, aligned: bool = True) -> str:
    """The backward kernels a call of head dim ``d`` takes: "mma" (bf16 on
    the tensor cores) for bf16 with D a multiple of 16 up to 128 when
    every row is 16-byte aligned, else "simt" (fp32 on the CUDA cores)."""
    if dtype == torch.bfloat16 and d % 16 == 0 \
            and 16 <= d <= MAX_MMA_BWD_HEAD_DIM and aligned:
        return "mma"
    return "simt"


def load() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its signature."""
    return _build.load(SOURCE, SIGNATURES)


def check_qkv(name: str, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, window: Optional[int]) -> None:
    """Raise unless q [B, H, Sq, D] and k, v [B, KV, Skv, D] are
    contiguous CUDA tensors of one device and dtype that the kernels
    take."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name} launches a CUDA kernel; got tensors on "
                         f"{dev}")
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{arg} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
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


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        with_lse: bool = False):
    """Attention forward on the card.  q: [B, H, Sq, D]; k/v: [B, KV, Skv,
    D] (fp32 or bf16, all three alike; any Sq and Skv) -> [B, H, Sq, D] in
    q's dtype; with ``with_lse``, (that, each row's log-sum-exp of its
    scaled scores fp32 [B, H, Sq])."""
    check_qkv("flash_attention_fwd", q, k, v, window)
    _build.refuse_grad("flash_attention_fwd", "ops.flash_attention", q, k, v)
    out = torch.empty_like(q)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() > 0:
        kind = variant(q.dtype, q.shape[3], all(t.data_ptr() % 16 == 0
                                                for t in (q, k, v, out)))
        launch(kind, q, k, v, out, causal, window, lse)
        launches["flash_attention"] += 1
        variant_launches[kind] += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None):
    """Attention backward on the card: from the forward's q, k, v, out and
    lse (``flash_attention_fwd(..., with_lse=True)``) and dout [B, H, Sq,
    D] (any strides with D's 1) -> (dq, dk, dv) in the inputs' dtype,
    dk and dv summed over each KV head's G query heads."""
    check_qkv("flash_attention_bwd", q, k, v, window)
    for arg, t, dtype, shape in (("out", out, q.dtype, q.shape),
                                 ("dout", dout, q.dtype, q.shape),
                                 ("lse", lse, torch.float32, q.shape[:3])):
        if t.device != q.device or t.dtype != dtype or t.shape != shape:
            raise ValueError(f"{arg}: {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected {dtype} "
                             f"{tuple(shape)} on {q.device}")
    if not out.is_contiguous() or not lse.is_contiguous() \
            or dout.stride(3) != 1:
        raise ValueError("out and lse must be contiguous and dout's last "
                         "dimension dense")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    rows_aligned = all(s * dout.element_size() % 16 == 0
                       for s in dout.stride()[:3])
    kind = bwd_variant(q.dtype, d, rows_aligned and all(
        t.data_ptr() % 16 == 0 for t in (q, k, v, out, dout, dq, dk, dv)))
    # Delta (and, for the tensor cores, lse in log2 units), written by the
    # dQ kernel and read by the dK/dV kernel
    scratch = torch.empty(
        (2, b, h, -(-sq // BWD_ROW_TILE) * BWD_ROW_TILE)
        if kind == "mma" else q.shape[:3],
        dtype=torch.float32, device=q.device)
    lib = load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            int(kind == "mma"), DTYPES[q.dtype], b, h, kvh, sq, skv, d,
            int(causal), 0 if window is None else int(window),
            *dout.stride()[:3], stream)
    _build.raise_on(err, f"flash_attention_bwd ({kind})")
    launches["flash_attention_bwd"] += 1
    bwd_variant_launches[kind] += 1
    return dq, dk, dv


def launch(kind: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, causal: bool, window: Optional[int],
           lse: Optional[torch.Tensor] = None) -> None:
    """Launch forward kernel ``kind`` on inputs the wrapper has checked
    (and ``variant`` allows for "mma"), writing each row's log-sum-exp
    into ``lse`` when given; counts nothing."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    lib = load()
    win = 0 if window is None else int(window)
    lse_ptr = None if lse is None else lse.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kind == "mma":
            err = lib.flash_attention_fwd_bf16_wgmma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse_ptr, b, h, kvh, sq, skv, d, int(causal), win, stream)
        else:
            err = lib.flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse_ptr, DTYPES[q.dtype], b, h, kvh, sq, skv, d,
                int(causal), win, stream)
    _build.raise_on(err, f"flash_attention_fwd ({kind})")
