"""Token data pipeline: deterministic, resumable, prefetched.

``SyntheticLM`` derives every batch from (seed, step) with a splitmix64
mix, so resuming at step N after a restart reproduces the byte-identical
stream with no state file (the property the resume tests assert).
``FileTokens`` samples fixed-length windows from a memory-mapped token
file, again purely (seed, step)-indexed.  ``Prefetcher`` runs the iterator
in a thread with a bounded queue so host batch assembly overlaps device
compute.

The reference's module unchanged in behaviour: numpy batches, so a
seeded stream is byte-identical in both packages; the train loop moves
each batch to the device.
"""
from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np


def _mix64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


class SyntheticLM:
    """Deterministic synthetic LM batches with learnable structure
    (a noisy repeat-previous-token pattern, so tiny models show a
    decreasing loss)."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.seed = np.uint64(seed)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        n = self.batch * (self.seq + 1)
        with np.errstate(over="ignore"):
            idx = (np.arange(n, dtype=np.uint64)
                   + np.uint64(step) * np.uint64(n + 1)
                   + self.seed * np.uint64(0x9E3779B97F4A7C15))
        h = _mix64(idx)
        # markov-ish stream: every other token repeats its predecessor
        raw = (h % np.uint64(self.vocab)).astype(np.int64)
        toks = raw.reshape(self.batch, self.seq + 1)
        toks[:, 1::2] = toks[:, 0:-1:2]      # predictable half
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}

    def iter_from(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(step)
            step += 1


class FileTokens:
    """Windows from a memory-mapped token file, (seed, step)-indexed."""

    def __init__(self, path: str, batch: int, seq_len: int,
                 dtype=np.uint16, seed: int = 0):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.n_windows = max(1, (len(self.tokens) - 1) // seq_len)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        idx = _mix64(np.arange(self.batch, dtype=np.uint64)
                     + np.uint64(step * self.batch)
                     + np.uint64(self.seed) * np.uint64(0x9E3779B9))
        starts = (idx % np.uint64(self.n_windows)).astype(np.int64) \
            * self.seq
        toks = np.stack([self.tokens[s:s + self.seq + 1].astype(np.int32)
                         for s in starts])
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def iter_from(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Bounded-queue background prefetch around any batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
