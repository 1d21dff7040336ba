"""Build and launch the CUDA paged decode attention kernel
(``csrc/paged_attention.cu``).

The source is compiled at first use with nvcc into a shared library and
bound with ctypes (``kernels/_build.py``).  The wrapper takes CUDA tensors
only, checks device, dtype, contiguity and shapes, allocates the output
and the split partials' scratch with ``torch.empty``, launches on the
current stream without synchronising, and raises if the launch was
refused.  ``launches`` counts its kernel launches.

The kernel splits each sequence's context across blocks (``split_plan``)
and its last block per (batch, KV head, group chunk) combines the splits,
so one launch does the whole call.  A block holds at most GROUP_CHUNK query
rows of its KV head, so a larger group is cut into ``group_chunks`` chunks
(Granite-34B's 48:1 MQA: three); a group of up to GROUP_CHUNK is one chunk.
The blocks find the last one with an int32 arrival counter per (batch, KV
head, chunk), which the kernel leaves at 0; the counters are made once per
device and reused, so launches on one device must share one stream.
``supports`` says which head counts the kernel takes; the wrapper raises
on exactly the others.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from .. import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
_VP, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"paged_attention_decode": [_VP] * 8 + [_I] * 9 + [_VP]}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
GROUP_CHUNK = 16        # query rows of one KV head a block holds
MAX_HEAD_DIM = 256
MAX_GRID_YZ = 65535     # CUDA's limit on a grid's y and z extents
MIN_SPLIT = 64          # positions a block takes at least
MAX_SPLITS = 128        # blocks per (batch, KV head) at most

launches: Dict[str, int] = {"paged_attention": 0}
_counters: Dict[torch.device, torch.Tensor] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def split_plan(max_pages: int, page_size: int) -> Tuple[int, int]:
    """(positions a split takes, splits) for a block table of
    ``max_pages`` slots of ``page_size`` positions: whole pages, at least
    MIN_SPLIT positions, and at most MAX_SPLITS splits over the table's
    capacity.  Known on the host without reading the context lengths."""
    if max_pages < 1 or page_size < 1:
        raise ValueError(f"max_pages={max_pages}, page_size={page_size}: "
                         "both must be >= 1")
    pages = max(-(-MIN_SPLIT // page_size), -(-max_pages // MAX_SPLITS))
    return pages * page_size, -(-max_pages // pages)


def group_chunks(h: int, kvh: int) -> int:
    """Blocks a (batch, KV head, split) takes: ceil(G / GROUP_CHUNK) for
    a group of G = h / kvh query heads, chunk c the rows [GROUP_CHUNK c,
    min(GROUP_CHUNK (c + 1), G))."""
    return -(-(h // kvh) // GROUP_CHUNK)


def supports(h: int, kvh: int, d: int) -> bool:
    """Whether the kernel takes ``h`` query heads of head dim ``d`` on
    ``kvh`` KV heads: any group (H % KV == 0), as many KV heads x chunks
    as the grid's y extent holds, and 1 <= D <= MAX_HEAD_DIM."""
    return (1 <= kvh <= h and h % kvh == 0 and 1 <= d <= MAX_HEAD_DIM
            and kvh * group_chunks(h, kvh) <= MAX_GRID_YZ)


def counters(dev: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 arrival counters on ``dev``, made once
    and grown when a launch needs more; the kernel leaves them at 0."""
    c = _counters.get(dev)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 64), dtype=torch.int32, device=dev)
        _counters[dev] = c
    return c


def load() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its signature."""
    return _build.load(SOURCE, SIGNATURES)


def paged_attention_decode(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           context_lens: torch.Tensor) -> torch.Tensor:
    """One-token decode over paged KV on the card.

    q: [B, H, D]; k_pages/v_pages: [P, page_size, KV, D] (fp32 or bf16,
    all three alike); block_tables: int32 [B, max_pages], every entry a
    page in [0, P) (pad with 0); context_lens: int32 [B], the index of the
    newest valid token, >= 0.  Returns [B, H, D] in q's dtype."""
    dev = k_pages.device
    if dev.type != "cuda":
        raise ValueError("paged_attention_decode launches a CUDA kernel; "
                         f"got tensors on {dev}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables),
                    ("context_lens", context_lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError("q, k_pages and v_pages must share one dtype of "
                        f"{list(DTYPES)}; got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("block_tables and context_lens must be int32")
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    bsz, h, d = q.shape
    _, page_size, kvh, dk = k_pages.shape
    if dk != d or not supports(h, kvh, d):
        raise ValueError(f"q heads {h} x {d} against {kvh} KV heads x {dk}: "
                         f"needs H % KV == 0, KV x ceil(H / KV / "
                         f"{GROUP_CHUNK}) <= {MAX_GRID_YZ}, "
                         f"D <= {MAX_HEAD_DIM}")
    if block_tables.dim() != 2 or block_tables.shape[0] != bsz \
            or block_tables.shape[1] < 1 or context_lens.shape != (bsz,) \
            or bsz > MAX_GRID_YZ:
        raise ValueError(f"block_tables {tuple(block_tables.shape)} and "
                         f"context_lens {tuple(context_lens.shape)} for "
                         f"batch {bsz} (at most {MAX_GRID_YZ})")
    out = torch.empty_like(q)
    if bsz == 0:
        return out
    max_pages = block_tables.shape[1]
    split, n_splits = split_plan(max_pages, page_size)
    scratch = torch.empty(bsz * h * n_splits * (d + 2),
                          dtype=torch.float32, device=dev)
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.paged_attention_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
            scratch.data_ptr(),
            counters(dev, bsz * kvh * group_chunks(h, kvh)).data_ptr(),
            DTYPES[q.dtype], bsz, h, kvh, d, page_size, max_pages, split,
            n_splits, stream)
    _build.raise_on(err, "paged_attention_decode")
    launches["paged_attention"] += 1
    return out
