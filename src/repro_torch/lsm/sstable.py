"""SSTable representation for the simulated LSM-tree.

Keys are uint64 ranks held in sorted numpy arrays (compact and fast to merge
with vectorised numpy); per-key tombstone bits support deletes.  Values are
optionally materialised (correctness tests / the quickstart example run with
``store_values=True``; large benchmark runs track sizes only).

Each SST carries a Bloom filter in one of two modes (``LSMConfig.filters``):

* ``"real"`` (default): a packed uint32 bit array built from the key set by
  ``repro_torch.lsm.filters`` (splitmix64-derived double hashing, shared
  bit-for-bit with the ``repro_torch.kernels.bloom_probe`` CUDA kernel and
  its plain PyTorch version), stored in ``filter_words``/``filter_k``.
* ``"injected"``: the original differential oracle — membership is exact
  via binary search (we *have* the key set) and false positives are
  injected deterministically from a hash of (key, sst uid) at the
  configured FP rate, reproducing the paper's ~1% Bloom FP read
  amplification without storing bit arrays.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

_MIX = np.uint64(0x9E3779B97F4A7C15)


def _mix64(x: np.ndarray | int) -> np.ndarray | int:
    """splitmix64 finaliser — deterministic hash for bloom FP injection."""
    x = np.uint64(x) if np.isscalar(x) else x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x


def merge_runs(runs_newest_first: List[np.ndarray],
               tombs_newest_first: List[np.ndarray]):
    """Merge sorted key runs, newest first; newest version of each key wins.

    Returns (keys, tombstones) sorted ascending, deduplicated.
    """
    if not runs_newest_first:
        return (np.empty(0, np.uint64), np.empty(0, np.bool_))
    keys = np.concatenate(runs_newest_first)
    tombs = np.concatenate(tombs_newest_first)
    # stable sort keeps newest-first order among equal keys
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    tombs = tombs[order]
    first = np.ones(len(keys), dtype=bool)
    first[1:] = keys[1:] != keys[:-1]
    return keys[first], tombs[first]


@dataclass
class SST:
    sid: int
    level: int
    keys: np.ndarray                      # sorted uint64
    tombs: np.ndarray                     # bool per key
    obj_size: int                         # bytes per KV object (key+value)
    block_size: int                       # data block bytes
    birth: float = 0.0
    tier: str = ""                        # "ssd" | "hdd" — set by the middleware
    zones: list = field(default_factory=list)
    num_reads: int = 0
    locked: bool = False                  # selected by a running compaction
    migrating: bool = False               # being moved between tiers
    values: Optional[Dict[int, bytes]] = None
    # real Bloom filter (filters="real"): packed uint32 bit array + probe
    # count, built by repro_torch.lsm.filters.attach_filter; None under the
    # injected-FP oracle mode
    filter_words: Optional[np.ndarray] = None
    filter_k: int = 0

    # ------------------------------------------------------------------
    @property
    def num_objs(self) -> int:
        return len(self.keys)

    @property
    def objs_per_block(self) -> int:
        return max(1, self.block_size // self.obj_size)

    @property
    def num_blocks(self) -> int:
        return -(-self.num_objs // self.objs_per_block)

    @property
    def size_bytes(self) -> int:
        return self.num_objs * self.obj_size

    @property
    def min_key(self) -> int:
        return int(self.keys[0])

    @property
    def max_key(self) -> int:
        return int(self.keys[-1])

    def read_rate(self, now: float) -> float:
        """Reads/s since birth — the priority signal of §3.4."""
        age = max(now - self.birth, 1e-9)
        return self.num_reads / age

    # ------------------------------------------------------------------
    def find(self, key: int):
        """Exact membership. Returns (found, idx)."""
        idx = int(np.searchsorted(self.keys, np.uint64(key)))
        found = idx < self.num_objs and int(self.keys[idx]) == key
        return found, idx

    def block_of(self, idx: int) -> int:
        return idx // self.objs_per_block

    def bloom_maybe_contains(self, key: int, fp_rate: float) -> bool:
        """Bloom probe: exact positives + deterministic false positives."""
        found, _ = self.find(key)
        if found:
            return True
        if fp_rate <= 0.0:
            return False
        h = int(_mix64(np.uint64(key) ^ _mix64(np.uint64(self.sid))))
        return (h % 1_000_000) < int(fp_rate * 1_000_000)

    def count_in_range(self, lo: int, hi: int) -> int:
        """Number of keys in [lo, hi)."""
        a = int(np.searchsorted(self.keys, np.uint64(lo), side="left"))
        b = int(np.searchsorted(self.keys, np.uint64(hi), side="left"))
        return b - a

    def overlaps(self, lo: int, hi: int) -> bool:
        """Key-range overlap with [lo, hi] inclusive."""
        return not (self.max_key < lo or self.min_key > hi)
