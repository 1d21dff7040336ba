"""HHZS-hinted tier manager for paged KV caches (HBM <-> host).

Reuses the paper's three techniques on the KV-cache placement problem,
driven by the same hint vocabulary (``core/hints.py``):

  write-guided placement   new KV zones (prefill ≙ flush, growth past a
      length bucket ≙ compaction into the next level) go to HBM while the
      *demand* of active sequences fits — demand is computed from admitted
      requests exactly as §3.3 computes per-level storage demands from
      flushing/compaction hints;
  workload-aware migration rate-limited background promotion/demotion:
      paused or preempted sequences (lowest priority: deeper length bucket,
      colder access) demote to host; resumed sequences promote back —
      §3.4's capacity/popularity migration with the HDD read-rate trigger
      replaced by the decode scheduler's active set;
  hinted caching           a reserved HBM zone pool caches the *prefix*
      (attention-sink) pages of host-resident sequences — the blocks every
      future decode step of that sequence will touch first (the cache hint
      fires when a sequence demotes, i.e. when its pages are evicted from
      the fast tier, mirroring §3.5's eviction-driven admission).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .paged_kv import KVZone, PagedPool


@dataclass
class SeqKV:
    sid: int
    length: int = 0
    tier: str = "hbm"                     # "hbm" | "host"
    zones: List[KVZone] = field(default_factory=list)
    last_active_step: int = 0
    prefix_cached: bool = False

    def level(self, base: int = 512) -> int:
        """Length bucket ≙ LSM level (exponentially growing)."""
        lvl = 0
        n = max(self.length, 1)
        while n > base:
            n //= 4
            lvl += 1
        return lvl

    def priority_key(self, step: int) -> Tuple[int, int]:
        """Smaller = higher priority: recently active first, then shallower
        level (short sequences are cheap to keep hot)."""
        return (step - self.last_active_step, self.level())


class HHZSKVManager:
    def __init__(self, hbm: PagedPool, host: PagedPool,
                 cache_zones: int = 2,
                 migration_zone_budget_per_step: int = 1):
        self.hbm = hbm
        self.host = host
        self.seqs: Dict[int, SeqKV] = {}
        self.step = 0
        # reserved HBM zones for prefix caching (≙ WAL/cache zones)
        self.cache_pool: List[KVZone] = []
        for _ in range(cache_zones):
            z = hbm.alloc_zone(owner=-1)
            if z is not None:
                self.cache_pool.append(z)
        self.prefix_cache: Dict[int, KVZone] = {}   # sid -> cache zone
        self._cache_fifo: List[int] = []
        self.migration_budget = migration_zone_budget_per_step
        self.stats = {"demotions": 0, "promotions": 0, "cache_admits": 0,
                      "cache_hits": 0, "bytes_migrated": 0,
                      "hbm_placements": 0, "host_placements": 0,
                      "demote_pages": 0, "promote_pages": 0,
                      "preempt_stalls": 0}

    # ------------------------------------------------------------------
    # hints
    # ------------------------------------------------------------------
    def admit(self, sid: int, total_tokens: int) -> bool:
        """Capacity admission hook: may this sequence (prompt + budgeted
        output, ``total_tokens``) enter at all?  The tiered policies always
        admit — host capacity backs the overflow; the static HBM-only
        baseline overrides this with a reject-on-full check."""
        return True

    def on_prefill(self, sid: int, tokens: int) -> SeqKV:
        """Flush hint: a new KV segment appears.

        Write-guided placement (§3.3): the incoming sequence is *hot* (it
        decodes immediately), so the fast tier is cleared for it by
        demoting cold residents — never active ones — until its demand
        fits.  Only when no cold victim remains does the prefill land on
        the slow tier."""
        seq = SeqKV(sid=sid, last_active_step=self.step)
        self.seqs[sid] = seq
        need = self._zones_for(tokens)
        while self.hbm.num_free() < need + self._active_demand() \
                and self._demote_one(exclude=sid, cold_only=True):
            pass
        if self.hbm.num_free() >= need + self._active_demand():
            seq.tier = "hbm"
            self.stats["hbm_placements"] += 1
        else:
            seq.tier = "host"
            self.stats["host_placements"] += 1
        return seq

    def on_growth(self, seq: SeqKV) -> None:
        """Compaction hint analogue: sequence crossed a level boundary."""
        # placement re-evaluated on the next zone allocation

    def _zones_for(self, tokens: int) -> int:
        zsz = self.hbm.page_size * self.hbm.pages_per_zone
        return -(-max(tokens, 1) // zsz)

    def _active_demand(self) -> int:
        """Zones the currently-active set will need soon (≙ §3.3 demands)."""
        demand = 0
        for s in self.seqs.values():
            if s.tier == "hbm" and self.step - s.last_active_step <= 1:
                if s.zones and s.zones[-1].remaining(self.hbm.page_size) < 8:
                    demand += 1
        return demand

    # ------------------------------------------------------------------
    # allocation on the write path
    # ------------------------------------------------------------------
    def pool_of(self, seq: SeqKV) -> PagedPool:
        return self.hbm if seq.tier == "hbm" else self.host

    def writable_zone(self, seq: SeqKV) -> KVZone:
        pool = self.pool_of(seq)
        if seq.zones and seq.zones[-1].remaining(pool.page_size) > 0:
            return seq.zones[-1]
        z = pool.alloc_zone(seq.sid)
        if z is None and seq.tier == "hbm":
            # capacity migration: demote the lowest-priority HBM sequence
            if not self._demote_one(exclude=seq.sid):
                self._seq_to_host(seq)
                return self.writable_zone(seq)
            z = pool.alloc_zone(seq.sid)
        if z is None:
            z = self.host.alloc_zone(seq.sid)
            if z is None:
                raise RuntimeError("host KV pool exhausted")
            if seq.tier == "hbm":
                self._seq_to_host(seq)
        seq.zones.append(z)
        return z

    # ------------------------------------------------------------------
    # migration (≙ §3.4, rate-limited per decode step)
    # ------------------------------------------------------------------
    def tick(self, active_sids: List[int]) -> None:
        """Called once per decode step with the active sequence set."""
        self.step += 1
        for sid in active_sids:
            if sid in self.seqs:
                self.seqs[sid].last_active_step = self.step
        budget = self.migration_budget
        # popularity migration: promote active host-resident sequences —
        # into free slack, or by displacing *cold* residents only.  The
        # hint keeps a promotion from evicting another active sequence
        # (the ping-pong a hint-blind pager pays; cf. LRUKVManager.tick)
        for sid in active_sids:
            seq = self.seqs.get(sid)
            if seq is None or seq.tier != "host" or budget <= 0:
                continue
            while self.hbm.num_free() < len(seq.zones) \
                    and self._demote_one(exclude=sid, cold_only=True):
                pass
            if self.hbm.num_free() >= len(seq.zones):
                budget -= self._promote(seq)

    def _victim_key(self, s: SeqKV):
        """Demotion victim ordering (max wins).  The hinted policy uses the
        paper's hint vocabulary — coldest first, then deepest length bucket
        (short sequences are cheap to keep hot); the LRU baseline overrides
        this with pure recency."""
        return s.priority_key(self.step)

    def _demote_one(self, exclude: int, cold_only: bool = False) -> bool:
        cands = [s for s in self.seqs.values()
                 if s.tier == "hbm" and s.sid != exclude and s.zones
                 and not (cold_only
                          and s.last_active_step >= self.step)]
        if not cands:
            return False
        victim = max(cands, key=self._victim_key)
        if victim.last_active_step >= self.step:
            # evicting a sequence that decoded this very step: the next
            # decode of that sequence stalls on host-resident KV
            self.stats["preempt_stalls"] += 1
        self._seq_to_host(victim)
        self.stats["demotions"] += 1
        return True

    def _seq_to_host(self, seq: SeqKV) -> None:
        # hinted caching first (≙ §3.5 eviction-driven admission): the
        # prefix must be copied while its HBM zones still hold valid data —
        # admitting after the reset below would cache an empty zone and
        # read from freed pages
        self._cache_admit(seq)
        new_zones = []
        for z in seq.zones:
            dz = self.host.alloc_zone(seq.sid)
            if dz is None:
                raise RuntimeError("host KV pool exhausted")
            self.stats["bytes_migrated"] += \
                self.host.copy_zone_from(self.hbm, z, dz)
            self.stats["demote_pages"] += len(z.pages)
            self.hbm.reset_zone(z)
            new_zones.append(dz)
        seq.zones = new_zones
        seq.tier = "host"

    def _promote(self, seq: SeqKV) -> int:
        # all-or-nothing: reserve every destination zone before touching a
        # single source zone, so an abort cannot strand a live sequence
        # pointing at freed host zones (partial-promotion data loss)
        new_zones = []
        for _ in seq.zones:
            dz = self.hbm.alloc_zone(seq.sid)
            if dz is None:
                for nz in new_zones:
                    self.hbm.reset_zone(nz)
                return 0
            new_zones.append(dz)
        for z, dz in zip(seq.zones, new_zones):
            self.stats["bytes_migrated"] += \
                self.hbm.copy_zone_from(self.host, z, dz)
            self.stats["promote_pages"] += len(z.pages)
            self.host.reset_zone(z)
        seq.zones = new_zones
        seq.tier = "hbm"
        self.stats["promotions"] += 1
        self._cache_drop(seq.sid)   # resident again: cached copy redundant
        return max(len(new_zones), 1)

    # ------------------------------------------------------------------
    # prefix caching (≙ §3.5)
    # ------------------------------------------------------------------
    def _cache_admit(self, seq: SeqKV) -> None:
        if not self.cache_pool or seq.sid in self.prefix_cache \
                or not seq.zones:
            return
        if len(self.prefix_cache) >= len(self.cache_pool):
            # FIFO zone eviction: the new entry takes over the *evicted*
            # entry's zone — indexing by occupancy here would overwrite a
            # zone another cached sequence still maps (cache collision)
            old = self._cache_fifo.pop(0)
            zone = self.prefix_cache.pop(old)
            old_seq = self.seqs.get(old)
            if old_seq is not None:
                old_seq.prefix_cached = False
        else:
            used = {z.zid for z in self.prefix_cache.values()}
            zone = next(z for z in self.cache_pool if z.zid not in used)
        self.hbm.copy_zone_from(self.hbm, seq.zones[0], zone)
        self.prefix_cache[seq.sid] = zone
        self._cache_fifo.append(seq.sid)
        seq.prefix_cached = True
        self.stats["cache_admits"] += 1

    def _cache_drop(self, sid: int) -> None:
        if sid in self.prefix_cache:
            self.prefix_cache.pop(sid)
            if sid in self._cache_fifo:
                self._cache_fifo.remove(sid)
            seq = self.seqs.get(sid)
            if seq is not None:
                seq.prefix_cached = False

    def cache_lookup(self, sid: int) -> Optional[KVZone]:
        z = self.prefix_cache.get(sid)
        if z is not None:
            self.stats["cache_hits"] += 1
        return z

    def residency(self, seq: SeqKV) -> Tuple[int, int]:
        """(hbm_tokens, host_tokens) a full attention read of this sequence
        touches right now.  For a host-resident sequence the cached prefix
        zone (if any) serves its span at HBM speed — the §3.5 payoff the
        serving cost model charges for."""
        if seq.tier == "hbm":
            return seq.length, 0
        cz = self.cache_lookup(seq.sid)
        cached = min(cz.write_ptr, seq.length) if cz is not None else 0
        return cached, seq.length - cached

    # ------------------------------------------------------------------
    def release(self, sid: int) -> None:
        """Sequence finished: reset all its zones (zone-granular reclaim)."""
        seq = self.seqs.pop(sid, None)
        if seq is None:
            return
        pool = self.pool_of(seq)
        for z in seq.zones:
            pool.reset_zone(z)
        self._cache_drop(sid)
