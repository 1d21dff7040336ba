"""What the drivers share: the reference's precision switch, the gap of
two sets of norms, a seeded sample and program patches for planted
faults."""
from __future__ import annotations

import contextlib
import statistics
from typing import Dict, List

import numpy as np
import torch


@contextlib.contextmanager
def exact_fp32():
    """Float32 products without TF32, for the reference."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def sample(seed: int, n: int, k: int) -> List[int]:
    """k of range(n), drawn from the seed, in order."""
    rng = np.random.default_rng(int(seed))
    return sorted(int(i) for i in rng.choice(n, size=min(k, n),
                                             replace=False))


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             names: List[str]) -> float:
    """The worst leaf's gap between two norms, over the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


class Patches:
    """Attributes of the program replaced for a planted fault, and put
    back."""

    def __init__(self):
        self._undo = []

    def set(self, owner, attr: str, value) -> None:
        self._undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    def undo(self) -> None:
        while self._undo:
            owner, attr, old = self._undo.pop()
            setattr(owner, attr, old)
