"""Application-hinted caching (§3.5).

Data blocks evicted from the LSM-tree's in-memory block cache are admitted
into SSD *cache zones* when they live on the HDD and are not already cached.
Cache zones are carved from the reserved WAL/cache zone pool and filled
append-only; eviction is FIFO at *zone* granularity (reset the oldest cache
zone, drop its mappings).  An in-memory mapping table (HDD location ->
SSD cache location) serves lookups; an in-memory FIFO queue identifies the
blocks in the evicted zone.
"""
from __future__ import annotations

from collections import defaultdict, deque
from typing import Deque, Dict, List, Optional, Set, Tuple, TYPE_CHECKING

from ..zoned.device import Zone

if TYPE_CHECKING:
    from .middleware import HybridZonedBackend

BlockKey = Tuple[int, int]  # (sst_id, block_idx)


class HintedCache:
    def __init__(self, backend: "HybridZonedBackend", block_size: int):
        self.backend = backend
        self.block_size = block_size
        self.mapping: Dict[BlockKey, int] = {}     # block -> zone id
        self.fifo: Deque[Tuple[int, int, int]] = deque()  # (sst, blk, zone id)
        self.by_sst: Dict[int, Set[int]] = defaultdict(set)
        self.zones: List[Zone] = []                # FIFO order, oldest first
        self.active: Optional[Zone] = None
        # stats
        self.admitted = 0
        self.rejected = 0
        self.hits = 0
        self.zone_evictions = 0

    # ------------------------------------------------------------------
    def lookup(self, sst_id: int, block_idx: int) -> bool:
        return (sst_id, block_idx) in self.mapping

    def record_hit(self) -> None:
        self.hits += 1

    # ------------------------------------------------------------------
    def admit(self, sst_id: int, block_idx: int, sst_tier: str):
        """Generator: admit an evicted data block (cache hint path, Fig. 4)."""
        be = self.backend
        key = (sst_id, block_idx)
        if sst_tier != "hdd" or key in self.mapping:
            self.rejected += 1
            return
        zone = self._writable_zone()
        if zone is None:
            self.rejected += 1
            return
        yield be.ssd.append(zone, self.block_size, tag="cache", background=True)
        self.mapping[key] = zone.zid
        self.by_sst[sst_id].add(block_idx)
        self.fifo.append((sst_id, block_idx, zone.zid))
        self.admitted += 1

    def _writable_zone(self) -> Optional[Zone]:
        if self.active is not None and self.active.remaining >= self.block_size:
            return self.active
        # Controller-driven reservation knob (repro_torch.obs.control): when the
        # backend caps cache_zone_budget, stay within it by recycling our
        # own oldest zone instead of claiming another reserved zone.
        budget = self.backend.cache_zone_budget
        if budget is not None and len(self.zones) >= budget:
            if budget <= 0 or not self.zones:
                return None
            self.evict_oldest_zone()
        # Need a fresh zone from the reserved WAL/cache pool.
        zone = self.backend.acquire_reserved_zone("cache")
        if zone is None:
            # All reserved zones busy: FIFO-evict the oldest cache zone and
            # retry (if *we* hold a zone); otherwise the WAL owns everything
            # and the block is simply dropped.
            if self.zones:
                self.evict_oldest_zone()
                zone = self.backend.acquire_reserved_zone("cache")
            if zone is None:
                return None
        self.active = zone
        self.zones.append(zone)
        return zone

    # ------------------------------------------------------------------
    def evict_oldest_zone(self) -> None:
        """FIFO policy (§3.5): reset the oldest cache zone, drop its blocks."""
        if not self.zones:
            return
        victim = self.zones.pop(0)
        if victim is self.active:
            self.active = None
        # Dequeue the location info of every block in the evicted zone.
        while self.fifo and self.fifo[0][2] == victim.zid:
            sst_id, blk, _ = self.fifo.popleft()
            self.mapping.pop((sst_id, blk), None)
            s = self.by_sst.get(sst_id)
            if s is not None:
                s.discard(blk)
                if not s:
                    del self.by_sst[sst_id]
        self.backend.release_reserved_zone(victim)
        self.zone_evictions += 1

    def on_zone_fault(self, zone: Zone) -> None:
        """A cache zone was reset by a device fault: its blocks are gone.

        Cache zones hold clean copies of HDD-resident blocks, so nothing
        needs repair — drop the zone and the mapping entries pointing at
        it (reads fall back to the HDD)."""
        if zone is self.active:
            self.active = None
        if zone in self.zones:
            self.zones.remove(zone)
        kept: Deque[Tuple[int, int, int]] = deque()
        for sst_id, blk, zid in self.fifo:
            if zid == zone.zid:
                self.mapping.pop((sst_id, blk), None)
                s = self.by_sst.get(sst_id)
                if s is not None:
                    s.discard(blk)
                    if not s:
                        del self.by_sst[sst_id]
            else:
                kept.append((sst_id, blk, zid))
        self.fifo = kept

    def clear_volatile(self) -> None:
        """Crash recovery: the in-memory mapping table is gone, so every
        cached block is unreachable — the recovery zone-map rebuild has
        already reset the zones; drop all bookkeeping (stats survive)."""
        self.mapping.clear()
        self.fifo.clear()
        self.by_sst.clear()
        self.zones = []
        self.active = None

    def drop_sst(self, sst_id: int) -> None:
        """An SST died (compaction/migration): its cached blocks are stale."""
        blocks = self.by_sst.pop(sst_id, None)
        if not blocks:
            return
        for blk in blocks:
            self.mapping.pop((sst_id, blk), None)
        # fifo entries become stale; they are skipped when their mapping is
        # already gone at zone-eviction time (cheap lazy deletion).

    def cached_blocks(self) -> int:
        return len(self.mapping)
