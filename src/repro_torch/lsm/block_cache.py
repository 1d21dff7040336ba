"""In-memory LRU block cache (RocksDB-style), emitting cache hints on eviction.

Entries are keyed by (sst_id, block_idx).  On eviction the registered
callback receives the victim — this is the paper's *cache hint* (§3.1): the
HHZS middleware uses it to admit the evicted block into SSD cache zones.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional, Tuple

Key = Tuple[int, int]  # (sst_id, block_idx)


class BlockCache:
    def __init__(self, capacity_blocks: int,
                 on_evict: Optional[Callable[[int, int], None]] = None):
        self.capacity = int(capacity_blocks)
        self._od: "OrderedDict[Key, None]" = OrderedDict()
        self.on_evict = on_evict
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._od)

    def __contains__(self, key: Key) -> bool:
        return key in self._od

    def get(self, sst_id: int, block_idx: int) -> bool:
        key = (sst_id, block_idx)
        if key in self._od:
            self._od.move_to_end(key)
            self.hits += 1
            return True
        self.misses += 1
        return False

    def insert(self, sst_id: int, block_idx: int) -> None:
        if self.capacity <= 0:
            # a zero-capacity cache never held the block, so there is
            # nothing to evict: firing the hint here admitted every single
            # read into SSD cache zones in cache-less configs
            return
        key = (sst_id, block_idx)
        if key in self._od:
            self._od.move_to_end(key)
            return
        self._od[key] = None
        while len(self._od) > self.capacity:
            (vic_sst, vic_blk), _ = self._od.popitem(last=False)
            if self.on_evict is not None:
                self.on_evict(vic_sst, vic_blk)

    def drop_sst(self, sst_id: int) -> None:
        """Remove all blocks of a deleted SST (no hints for dead data)."""
        stale = [k for k in self._od if k[0] == sst_id]
        for k in stale:
            del self._od[k]

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
