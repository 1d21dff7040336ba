"""Build and launch the CUDA selective scan v1 kernel
(``csrc/selective_scan.cu``, which also holds the fused kernel and its
backward that ``fused.py`` launches).

The source is compiled at first use with nvcc into a shared library and
bound with ctypes (``kernels/_build.py``).  The wrapper takes CUDA fp32
contiguous tensors only, checks their shapes, refuses inputs that
require a gradient under grad mode (it has no backward), picks the
launch's shape with ``plan`` (a plain function of B, di and the card's
SM count; ``shape`` states it for given channels a block and stages),
allocates the output with ``torch.empty``, launches on the current stream
without synchronising, and raises if the launch was refused.
``launches`` counts its kernel launches.

v1 reads the N-fold bx, 72 bytes a (t, d) at N 16, so it is bound by
bytes: it streams dt, bx and C through a ring of shared-memory stages
(``STEPS`` steps each) with bulk copies, so that several stages are in
flight while one is scanned, and ``plan`` spreads the channels so that
the busiest SM carries as few as it can (see the source's header).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from .. import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan.cu"
_VP, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"selective_scan": [_VP] * 5 + [_I] * 6 + [_VP],
              "selective_scan_fused": [_VP] * 6 + [_I] * 5 + [_VP],
              "selective_scan_fused_bwd": [_VP] * 15 + [_I] * 5 + [_VP],
              "selective_scan_fused_bwd_occupancy":
                  [_I] * 2 + [ctypes.POINTER(_I)] * 4}
MAX_STATE = 16          # N the kernels hold: 16 states a channel
MAX_BATCH = 65535       # the grid's y dimension

# v1's launch (kV1* in the source)
LANES = 4               # lanes a channel, 4 states each
STEPS = 4               # steps a ring stage holds
MAX_THREADS = 1024      # a block's threads
MAX_STAGES = 8
HEADER = 128            # bytes of the stages' mbarriers
CHANNELS = range(256, 7, -8)    # channels a block ``plan`` weighs
MIN_STAGES = 3          # the fewest stages ``plan`` takes
# an H100 SM's shared memory, the most a block may take, and what the SM
# keeps back for each resident block
SM_SMEM, BLOCK_SMEM, BLOCK_RESERVED = 233472, 232448, 1024
SM_THREADS = 1024       # threads ``plan`` puts on an SM: 64 registers each

launches: Dict[str, int] = {"selective_scan": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


class Plan(NamedTuple):
    channels: int           # channels a block
    threads: int            # 4 lanes a channel
    stages: int             # ring stages of STEPS steps
    grid: Tuple[int, int]   # (di blocks, B)
    smem_bytes: int         # dynamic shared memory a block


def stage_bytes(channels: int) -> int:
    """One stage of a block: bx [STEPS][channels][16], dt
    [STEPS][channels], C [STEPS][16] in fp32."""
    return 4 * STEPS * (channels * (MAX_STATE + 1) + MAX_STATE)


def shape(b: int, di: int, channels: int, stages: int) -> Plan:
    """The launch of B * di channels, ``channels`` a block, over a ring of
    ``stages``, as ``csrc/selective_scan.cu`` makes it.  Raises on what
    the launcher refuses and on a grid the card does not take."""
    if channels % 8 or not 8 <= channels * LANES <= MAX_THREADS:
        raise ValueError(f"channels = {channels}: the kernel takes a "
                         f"multiple of 8 up to {MAX_THREADS // LANES}")
    if not 1 <= stages <= MAX_STAGES:
        raise ValueError(f"stages = {stages}: the kernel takes 1 to "
                         f"{MAX_STAGES}")
    grid = (-(-di // channels), b)
    if grid[0] < 1 or not 1 <= b <= MAX_BATCH:
        raise ValueError(f"grid {grid}: the card takes at least one block "
                         f"of di and 1..{MAX_BATCH} rows")
    smem = HEADER + stages * stage_bytes(channels)
    if smem > BLOCK_SMEM:
        raise ValueError(f"{stages} stages of {channels} channels take "
                         f"{smem} bytes; a block may take {BLOCK_SMEM}")
    return Plan(channels, channels * LANES, stages, grid, smem)


def busiest_sm(b: int, di: int, channels: int, sm_count: int) -> int:
    """Channels the busiest SM carries, its blocks spread evenly."""
    return -(-b * -(-di // channels) // sm_count) * channels


def plan_stages(b: int, di: int, channels: int, sm_count: int) -> int:
    """The most stages (up to MAX_STAGES) with which the blocks of
    ``channels`` that an SM runs at once (its share of the grid, at most
    SM_THREADS threads) fit in its shared memory."""
    per_sm = min(busiest_sm(b, di, channels, sm_count) // channels,
                 SM_THREADS // (channels * LANES))
    room = min(BLOCK_SMEM, SM_SMEM // per_sm - BLOCK_RESERVED) - HEADER
    return min(MAX_STAGES, room // stage_bytes(channels))


def plan(b: int, di: int, sm_count: int) -> Plan:
    """The launch the wrapper makes on a card of ``sm_count`` SMs: of
    CHANNELS, the channels a block that give the busiest SM the fewest
    channels (the most of them on a tie) with at least MIN_STAGES
    stages, and ``plan_stages`` of them."""
    best = None
    for channels in CHANNELS:
        stages = plan_stages(b, di, channels, sm_count)
        load = busiest_sm(b, di, channels, sm_count)
        if stages >= MIN_STAGES and (best is None or load < best[0]):
            best = (load, channels, stages)
    return shape(b, di, best[1], best[2])


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def launch(p: Plan, dt: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
           a: torch.Tensor, y: torch.Tensor) -> None:
    """Launch the kernel as ``p`` says on checked tensors (counts
    nothing: ``selective_scan`` is the entry point)."""
    b, t, di = dt.shape
    lib = load()
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = lib.selective_scan(dt.data_ptr(), bx.data_ptr(), c.data_ptr(),
                                 a.data_ptr(), y.data_ptr(), b, t, di,
                                 a.shape[1], p.channels, p.stages, stream)
    _build.raise_on(err, "selective_scan")


def selective_scan(dt: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                   a: torch.Tensor) -> torch.Tensor:
    """dt: [B, T, di]; bx: [B, T, di, N]; c: [B, T, N]; a: [di, N] (fp32,
    any T and di) -> y [B, T, di] fp32, on the card."""
    b, t, di, n = scan_dims(dt, a)
    check_args("selective_scan",
               [("dt", dt), ("bx", bx), ("c", c), ("a", a)],
               {"dt": (b, t, di), "bx": (b, t, di, n), "c": (b, t, n),
                "a": (di, n)})
    _build.refuse_grad("selective_scan", "ops.selective_scan_fused (the "
                       "scan with a backward)", dt, bx, c, a)
    y = torch.empty_like(dt)
    if y.numel() == 0:
        return y
    launch(plan(b, di, sm_count(dt.device)), dt, bx, c, a, y)
    launches["selective_scan"] += 1
    return y
