"""Token streams drawn from the run's seed, on the host, as a server or a
data loader would receive them.

``SyntheticLM`` is a copy of the port's training data generator
(``repro_torch/data/pipeline.py``): every batch a pure function of
(seed, step) through a splitmix64 mix, every other token repeating its
predecessor.  ``tokens`` draws uniform token ids for a stream and index:
prompts of the serving mixes."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def mix64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


class SyntheticLM:
    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int):
        self.vocab, self.batch, self.seq = vocab_size, batch, seq_len
        self.seed = np.uint64(seed)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        n = self.batch * (self.seq + 1)
        with np.errstate(over="ignore"):
            idx = (np.arange(n, dtype=np.uint64)
                   + np.uint64(step) * np.uint64(n + 1) + self.seed * GOLDEN)
        raw = (mix64(idx) % np.uint64(self.vocab)).astype(np.int64)
        toks = raw.reshape(self.batch, self.seq + 1)
        toks[:, 1::2] = toks[:, 0:-1:2]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}


def tokens(seed: int, stream: int, index: int, shape: Tuple[int, ...],
           vocab: int) -> np.ndarray:
    """Uniform ids in [0, vocab) of ``shape``, for (seed, stream, index)."""
    n = int(np.prod(shape))
    with np.errstate(over="ignore"):
        base = (np.uint64(seed) * GOLDEN
                + np.uint64(stream) * np.uint64(0xD1B54A32D192ED03)
                + np.uint64(index) * np.uint64(n + 1))
        idx = np.arange(n, dtype=np.uint64) + base
    return (mix64(idx) % np.uint64(vocab)).astype(np.int32).reshape(shape)


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``: through pinned memory, not blocking,
    on a card."""
    t = torch.from_numpy(arr)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
