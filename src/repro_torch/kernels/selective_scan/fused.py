"""Launch the CUDA fused selective scan kernel (``csrc/selective_scan.cu``,
built and bound by ``selective_scan.py``), which forms dt * x * B itself.

The wrapper takes CUDA fp32 contiguous tensors only, checks their shapes,
refuses inputs that require a gradient under grad mode
(``ops.selective_scan_fused`` is the differentiable entry point), picks the launch's shape with ``plan`` (a plain function of B, di and the
card's SM count; ``shape`` states it for given lanes a channel),
allocates the output with ``torch.empty``, launches on the current stream
without synchronising, and raises if the launch was refused.
``launches`` counts its kernel launches.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import torch

from .. import _build
from .selective_scan import MAX_BATCH, check_args, load, scan_dims

THREADS = 128           # a block's threads (kFusedThreads)
CHUNK = 32              # steps a shared-memory buffer holds (kFusedChunk)
LANES = (2, 4)          # lanes a channel the kernel is built for
# the fewest lanes a channel whose warps reach this many per SM (a warp
# for each of its four schedulers) take the launch; below it, the most
WARPS_PER_SM = 4

launches: Dict[str, int] = {"selective_scan_fused": 0}


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


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
