"""Least work of one call of each ported kernel, from its shapes: the
operations the algorithm needs and the bytes it must move, each input
byte read once and each output byte written once.  ``bound_s`` turns a
count into the least seconds the card could take.

The counts are those the port's bring-up used for its bounds:
- the fused selective scan: 6 operations a (t, d, n) forward (the
  exponent's argument, the decay, dt x B, the state, state x C, the sum)
  and 14 backward; fp32 throughout, so on the CUDA cores;
- flash attention: 4 flops a (query head, visible key, head dim)
  forward (QK^T and PV) and 10 backward (QK^T, dO V^T, P^T dO, dS^T Q,
  dS K); on the tensor cores for bf16 inputs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

from . import peaks

SCAN_FWD_OPS = 6
SCAN_BWD_OPS = 14
FLASH_FWD_FLOPS = 4
FLASH_BWD_FLOPS = 10


class Work(NamedTuple):
    ops: float          # operations (flops)
    nbytes: float       # bytes moved
    ops_rate: float     # peak operations a second for these operations

    def bound_s(self) -> float:
        """The least seconds: the larger of the two bounds."""
        return max(self.ops / self.ops_rate, self.nbytes / peaks.HBM_BYTES)


def visible_keys(sq: int, skv: int, causal: bool,
                 window: Optional[int]) -> int:
    """(query, key) pairs a flash call computes: every pair non-causal;
    causal, the key at or before the query and, with a window, fewer than
    ``window`` positions back (``kp > qp - window``)."""
    if not causal:
        return sq * skv
    total = 0
    w = window or skv
    for qp in range(sq):
        total += min(qp + 1, skv, w)
    return total


def scan_fwd(b: int, t: int, di: int, n: int) -> Work:
    """dt, x (fp32 [B, T, di]), B, C (fp32 [B, T, N]) and A (fp32 [di,
    N]) read; y (fp32 [B, T, di]) written."""
    nbytes = 4 * (3 * b * t * di + 2 * b * t * n + di * n)
    return Work(SCAN_FWD_OPS * b * t * di * n, nbytes, peaks.FP32_FLOPS)


def scan_bwd(b: int, t: int, di: int, n: int) -> Work:
    """dt, x, dy, B, C, A read; ddt, dx, dB, dC, dA written."""
    nbytes = 4 * (5 * b * t * di + 4 * b * t * n + 2 * di * n)
    return Work(SCAN_BWD_OPS * b * t * di * n, nbytes, peaks.FP32_FLOPS)


def _flash_rate(itemsize: int) -> float:
    return peaks.BF16_FLOPS if itemsize == 2 else peaks.FP32_FLOPS


def flash_bwd(b: int, h: int, kvh: int, sq: int, skv: int, d: int,
              causal: bool, window: Optional[int], itemsize: int) -> Work:
    """q, out, dout read and dq written ([B, H, Sq, D]); k, v read and
    dk, dv written ([B, KV, Skv, D]); the fp32 log-sum-exp [B, H, Sq]
    read."""
    pairs = visible_keys(sq, skv, causal, window)
    nbytes = itemsize * (4 * b * h * sq * d + 4 * b * kvh * skv * d) \
        + 4 * b * h * sq
    return Work(FLASH_BWD_FLOPS * b * h * d * pairs, nbytes,
                _flash_rate(itemsize))
