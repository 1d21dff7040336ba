"""Launch the CUDA fused selective scan kernel and its backward
(``csrc/selective_scan.cu``, built and bound by ``selective_scan.py``);
the forward forms dt * x * B itself.

The forward wrapper takes CUDA fp32 contiguous tensors only, checks their
shapes, refuses inputs that require a gradient under grad mode
(``ops.selective_scan_fused`` is the differentiable entry point), picks
the launch's shape with ``plan`` (a plain function of B, di and the card's
SM count; ``shape`` states it for given lanes a channel), allocates the
output with ``torch.empty``, launches on the current stream without
synchronising, and raises if the launch was refused.

``selective_scan_fused_bwd`` is the backward that the ``Function``
launches on the card: the same checks, then the gradients of dt, x, B, C
and A from the forward's inputs and dy, deterministic (no atomics: the
scan writes per-block partial sums of dB, dC and dA into scratch that a
last kernel adds in a fixed order; a first one lays B and C out in the
scan's state orders).  ``bwd_plan`` picks its launch (a
plain function of B, di and the card's SM count: the channels a block,
4 lanes each, that give the busiest SM the fewest channels; ``bwd_shape``
states it for given channels); ``bwd_scratch`` states the scratch it
allocates.  ``bwd_occupancy`` asks the card what it makes of the
compiled kernel at given channels a block: its shared memory, the blocks
an SM holds at once, its registers and spilled bytes a thread.
``launches`` counts one launch of each wrapper (the backward's three
kernels count once).
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from .. import _build
from .selective_scan import (MAX_BATCH, MAX_STATE, busiest_sm, check_args,
                             load, scan_dims, sm_count)

THREADS = 128           # a block's threads (kFusedThreads)
CHUNK = 32              # steps a shared-memory buffer holds (kFusedChunk)
LANES = (2, 4)          # lanes a channel the kernel is built for
# the fewest lanes a channel whose warps reach this many per SM (a warp
# for each of its four schedulers) take the launch; below it, the most
WARPS_PER_SM = 4

# the backward's launch (kBwd* in the source)
BWD_LANES = 4           # lanes a channel, 4 states each
BWD_CHUNK = 8           # steps a chunk
BWD_ORDERS = 4          # copies of B and C, in four state orders
BWD_MAX_THREADS = 512   # a block's threads: 128 registers each at most
BWD_CHANNELS = range(BWD_MAX_THREADS // BWD_LANES, 7, -8)  # ``bwd_plan``'s

launches: Dict[str, int] = {"selective_scan_fused": 0,
                            "selective_scan_fused_bwd": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


class Plan(NamedTuple):
    lanes: int              # lanes a channel, 16 / lanes states each
    channels: int           # channels a block
    grid: Tuple[int, int]   # (di blocks, B)
    smem_bytes: int         # static shared memory a block


def shape(b: int, di: int, lanes: int) -> Plan:
    """The launch of B * di channels with ``lanes`` lanes a channel, as
    ``csrc/selective_scan.cu`` makes it.  Raises on lanes the kernel is
    not built for and on a grid the card does not take."""
    if lanes not in LANES:
        raise ValueError(f"lanes = {lanes}: the kernel takes {LANES}")
    channels = THREADS // lanes
    grid = (-(-di // channels), b)
    if grid[0] < 1 or not 1 <= b <= MAX_BATCH:
        raise ValueError(f"grid {grid}: the card takes at least one block "
                         f"of di and 1..{MAX_BATCH} rows")
    # dt, x for the block's channels and B, C for 16 states, two buffers
    smem = 4 * 2 * CHUNK * (2 * channels + 2 * 16)
    return Plan(lanes, channels, grid, smem)


def plan(b: int, di: int, sm_count: int) -> Plan:
    """The launch the wrapper makes on a card of ``sm_count`` SMs: the
    fewest lanes a channel (of LANES) whose warps reach WARPS_PER_SM an
    SM, else the most."""
    lanes = next((n for n in LANES
                  if b * di * n >= WARPS_PER_SM * 32 * sm_count), LANES[-1])
    return shape(b, di, lanes)


def launch(p: Plan, dt: torch.Tensor, x: torch.Tensor, bm: torch.Tensor,
           c: torch.Tensor, a: torch.Tensor, y: torch.Tensor) -> None:
    """Launch the kernel as ``p`` says on checked tensors (counts
    nothing: ``selective_scan_fused`` is the entry point)."""
    b, t, di = dt.shape
    lib = load()
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = lib.selective_scan_fused(
            dt.data_ptr(), x.data_ptr(), bm.data_ptr(), c.data_ptr(),
            a.data_ptr(), y.data_ptr(), b, t, di, a.shape[1], p.lanes,
            stream)
    _build.raise_on(err, "selective_scan_fused")


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
    _build.refuse_grad("selective_scan_fused", "ops.selective_scan_fused",
                       dt, x, bm, c, a)
    y = torch.empty_like(dt)
    if y.numel() == 0:
        return y
    launch(plan(b, di, sm_count(dt.device)), dt, x, bm, c, a, y)
    launches["selective_scan_fused"] += 1
    return y


class BwdPlan(NamedTuple):
    channels: int           # channels a block
    threads: int            # 4 lanes a channel
    grid: Tuple[int, int]   # (di blocks, B)
    sm_blocks: int          # blocks the busiest SM runs, spread evenly


class BwdOccupancy(NamedTuple):
    smem_bytes: int         # dynamic shared memory a block
    blocks_per_sm: int      # blocks an SM holds at once
    registers: int          # a thread's, as compiled
    local_bytes: int        # a thread's spilled (local) bytes


def bwd_shape(b: int, di: int, channels: int, sm_count: int) -> BwdPlan:
    """The backward's launch of B * di channels, ``channels`` a block, as
    ``csrc/selective_scan.cu`` makes it on a card of ``sm_count`` SMs.
    Raises on what the launcher refuses and on a grid the card does not
    take."""
    threads = BWD_LANES * channels
    if channels % 8 or not 8 <= threads <= BWD_MAX_THREADS:
        raise ValueError(f"channels = {channels}: the backward takes a "
                         f"multiple of 8 up to {BWD_MAX_THREADS // BWD_LANES}")
    grid = (-(-di // channels), b)
    if grid[0] < 1 or not 1 <= b <= MAX_BATCH:
        raise ValueError(f"grid {grid}: the card takes at least one block "
                         f"of di and 1..{MAX_BATCH} rows")
    return BwdPlan(channels, threads, grid,
                   busiest_sm(b, di, channels, sm_count) // channels)


def bwd_plan(b: int, di: int, sm_count: int) -> BwdPlan:
    """The backward's launch on a card of ``sm_count`` SMs: of
    BWD_CHANNELS, the channels a block that give the busiest SM the fewest
    channels (the most of them on a tie)."""
    best = min(BWD_CHANNELS, key=lambda ch: busiest_sm(b, di, ch, sm_count))
    return bwd_shape(b, di, best, sm_count)


def bwd_scratch(b: int, t: int, di: int,
                channels: int) -> Dict[str, Tuple[int, ...]]:
    """The backward's fp32 scratch at ``channels`` a block: B and C in
    the scan's BWD_ORDERS state orders (``bcp``), the state at every
    chunk's end (``hbuf``), each block's sums of dB and dC a step
    (``part_bc``) and each batch row's dA (``part_a``)."""
    return {"bcp": (2, b, t, BWD_ORDERS, MAX_STATE),
            "hbuf": (b, -(-t // BWD_CHUNK), di, MAX_STATE),
            "part_bc": (b, -(-di // channels), t, 2 * MAX_STATE),
            "part_a": (b, di, MAX_STATE)}


def bwd_launch(p: BwdPlan, dt: torch.Tensor, x: torch.Tensor,
               bm: torch.Tensor, c: torch.Tensor, a: torch.Tensor,
               dy: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The backward's kernels launched as ``p`` says on checked
    tensors: (ddt, dx, dB, dC, dA) (counts nothing:
    ``selective_scan_fused_bwd`` is the entry point)."""
    b, t, di = dt.shape
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    dbm, dc, da = torch.empty_like(bm), torch.empty_like(c), \
        torch.empty_like(a)
    scratch = {k: torch.empty(s, dtype=torch.float32, device=dt.device)
               for k, s in bwd_scratch(b, t, di, p.channels).items()}
    lib = load()
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = lib.selective_scan_fused_bwd(
            dt.data_ptr(), x.data_ptr(), bm.data_ptr(), c.data_ptr(),
            a.data_ptr(), dy.data_ptr(), scratch["bcp"].data_ptr(),
            scratch["hbuf"].data_ptr(),
            scratch["part_bc"].data_ptr(), scratch["part_a"].data_ptr(),
            ddt.data_ptr(), dx.data_ptr(), dbm.data_ptr(), dc.data_ptr(),
            da.data_ptr(), b, t, di, a.shape[1], p.channels, stream)
    _build.raise_on(err, "selective_scan_fused_bwd")
    return ddt, dx, dbm, dc, da


def bwd_occupancy(channels: int, device: torch.device,
                  vec: bool = True) -> BwdOccupancy:
    """What ``device`` (a card) makes of the backward's scan kernel at
    ``channels`` a block, on its 16-byte route (``vec``) or its 4-byte
    one, as the CUDA runtime reports it for the compiled kernel."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"bwd_occupancy asks a card; got {device}")
    out = [ctypes.c_int() for _ in BwdOccupancy._fields]
    lib = load()
    with torch.cuda.device(device):
        err = lib.selective_scan_fused_bwd_occupancy(
            channels, int(vec), *(ctypes.byref(v) for v in out))
    _build.raise_on(err, "selective_scan_fused_bwd_occupancy")
    return BwdOccupancy(*(v.value for v in out))


def selective_scan_fused_bwd(dt: torch.Tensor, x: torch.Tensor,
                             bm: torch.Tensor, c: torch.Tensor,
                             a: torch.Tensor, dy: torch.Tensor
                             ) -> Tuple[torch.Tensor, ...]:
    """The fused scan's gradients on the card: from its inputs (dt/x [B,
    T, di]; bm/c [B, T, N]; a [di, N]) and dy [B, T, di], all fp32, ->
    (ddt, dx, dB, dC, dA) in the inputs' shapes, fp32."""
    b, t, di, n = scan_dims(dt, a)
    check_args("selective_scan_fused_bwd",
               [("dt", dt), ("x", x), ("bm", bm), ("c", c), ("a", a),
                ("dy", dy)],
               {"dt": (b, t, di), "x": (b, t, di), "bm": (b, t, n),
                "c": (b, t, n), "a": (di, n), "dy": (b, t, di)})
    if dt.numel() == 0:
        return (torch.empty_like(dt), torch.empty_like(x),
                torch.zeros_like(bm), torch.zeros_like(c),
                torch.zeros_like(a))
    grads = bwd_launch(bwd_plan(b, di, sm_count(dt.device)), dt, x, bm, c,
                       a, dy)
    launches["selective_scan_fused_bwd"] += 1
    return grads
