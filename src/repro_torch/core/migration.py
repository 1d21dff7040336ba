"""Workload-aware migration (§3.4).

Two migration types refine placement in the background:

  capacity migration   SSD -> HDD when the tiering level over-occupies its
                       reservation or SSTs above the tiering level sit in
                       the SSD (write-guided placement changed its mind);
  popularity migration HDD -> SSD when the aggregate HDD read rate exceeds
                       half the device's random-read IOPS (the HDD is the
                       read bottleneck); promotes the highest-priority HDD
                       SST, swapping with the lowest-priority SSD SST when
                       no zone is free.

SST priority: lower level first, then higher read rate (reads / age).  SSTs
locked by a running compaction (known from compaction hints) or by another
migration are never selected.  All migration I/O is rate-limited (default
4 MiB/s) to bound interference with foreground traffic.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, TYPE_CHECKING

from ..zoned.device import MiB

if TYPE_CHECKING:
    from ..lsm.sstable import SST
    from .middleware import HybridZonedBackend


def priority_key(sst: "SST", now: float) -> Tuple[int, float]:
    """Smaller tuple == higher priority (§3.4)."""
    return (sst.level, -sst.read_rate(now))


class Migrator:
    def __init__(self, backend: "HybridZonedBackend",
                 rate_limit: float = 4 * MiB,
                 chunk_bytes: int = int(1 * MiB),
                 tick: float = 0.25,
                 popularity_frac: float = 0.5,
                 swap_hysteresis: float = 1.5,
                 basic_low_levels: Optional[int] = None):
        self.backend = backend
        self.rate_limit = rate_limit
        self.chunk_bytes = chunk_bytes
        self.tick = tick
        self.popularity_frac = popularity_frac
        self.swap_hysteresis = swap_hysteresis
        # basic_low_levels=h: "B3+M" mode — only promote HDD SSTs at levels
        # < h; no capacity migration (the basic scheme statically pins levels).
        self.basic_low_levels = basic_low_levels
        # stats
        self.capacity_moves = 0
        self.popularity_moves = 0
        self.swaps = 0
        self.aborted = 0
        self.bytes_moved = 0.0

    # ------------------------------------------------------------------
    def start(self) -> None:
        self.backend.sim.process(self._run())

    def _run(self):
        be = self.backend
        while True:
            job = self._pick_job()
            if job is None:
                yield be.sim.timeout(self.tick, daemon=True)
                continue
            sst, dst, swap_victim = job
            moved = False
            if swap_victim is not None:
                ok = yield from self._migrate(swap_victim, "hdd")
                if ok:
                    self.swaps += 1
                    moved = True
            ok = yield from self._migrate(sst, dst)
            if not (ok or moved):
                # the picked job made no progress (preempted, no zones):
                # re-picking immediately would spin without advancing
                # virtual time, so back off one tick
                yield be.sim.timeout(self.tick, daemon=True)

    # ------------------------------------------------------------------
    def _unlocked(self, ssts: List["SST"]) -> List["SST"]:
        return [s for s in ssts if not s.locked and not s.migrating]

    def _pick_job(self):
        be = self.backend
        now = be.sim.now
        if self.basic_low_levels is None:
            # --- capacity migration (HHZS mode only) ----------------------
            t = be.placement.tiering_level()
            all_ssd = be.ssd_ssts()
            ssd_ssts = self._unlocked(all_ssd)
            at_t = [s for s in all_ssd if s.level == t]
            over_t = [s for s in all_ssd if s.level > t]
            reserved_t = be.placement.reserved_for_tiering(t) \
                if hasattr(be.placement, "reserved_for_tiering") else float("inf")
            # evict only when lower levels actually lack zones for their
            # demand — otherwise transient demand spikes (every compaction
            # trigger) cause chronic SSD<->HDD churn
            demands_below = sum(be.placement.demand_of(j) for j in range(t)) \
                if hasattr(be.placement, "demand_of") else 0.0
            starved = be.ssd_empty_sst_zones() < demands_below
            if (len(at_t) > reserved_t or over_t) and starved and ssd_ssts:
                victim = max(ssd_ssts, key=lambda s: priority_key(s, now))
                self.capacity_moves += 1
                return (victim, "hdd", None)
        # --- popularity migration ----------------------------------------
        hdd_iops = be.hdd.timing.rand_read_iops
        if be.hdd_read_rate() <= self.popularity_frac * hdd_iops:
            return None
        cands = self._unlocked(be.hdd_ssts())
        if self.basic_low_levels is not None:
            cands = [s for s in cands if s.level < self.basic_low_levels]
        if not cands:
            return None
        best = min(cands, key=lambda s: priority_key(s, now))
        if self._room_for_promotion():
            self.popularity_moves += 1
            return (best, "ssd", None)
        ssd_ssts = self._unlocked(be.ssd_ssts())
        if not ssd_ssts:
            return None
        victim = max(ssd_ssts, key=lambda s: priority_key(s, now))
        # hysteresis: swapping equal-level SSTs requires a clearly higher
        # read rate, otherwise marginal rate differences cause swap churn
        better = (best.level < victim.level
                  or (best.level == victim.level
                      and best.read_rate(now) >
                      victim.read_rate(now) * self.swap_hysteresis))
        if better:
            self.popularity_moves += 1
            return (best, "ssd", victim)
        return None

    def _room_for_promotion(self) -> bool:
        """Empty SSD zones must exceed total demands below the tiering level."""
        be = self.backend
        empty = be.ssd_empty_sst_zones()
        pl = be.placement
        if hasattr(pl, "reserved_for_tiering"):
            t = pl.tiering_level()
            demands_below = sum(pl.demand_of(j) + 0 for j in range(t))
            return empty > demands_below
        return empty > 0

    # ------------------------------------------------------------------
    def _migrate(self, sst: "SST", dst: str):
        """Move one SST between tiers, rate-limited. Returns True on success.

        Compaction preempts migration: if the SST is selected by a compaction
        (locked) or deleted while the copy is in flight, the migration aborts
        and its destination zones are reset.  The paper only states the
        converse (migration never selects compaction-selected SSTs, §3.4);
        letting the foreground-critical compaction win the race is the
        RocksDB-faithful resolution.
        """
        be = self.backend
        if sst.locked or sst.migrating or sst.tier == dst:
            return False
        sst.migrating = True
        new_zones = None
        try:
            new_zones = be.alloc_sst_zones(dst, sst.size_bytes, f"sst:{sst.sid}")
            if new_zones is None:
                return False
            src_dev = be.device_of(sst.tier)
            dst_dev = be.device_of(dst)
            start = be.sim.now
            done = 0
            total = sst.size_bytes
            zi = 0
            while done < total:
                if sst.locked or sst.sid not in be.ssts:
                    # preempted by compaction (or already compacted away)
                    self.aborted += 1
                    for z in new_zones:
                        be.device_of(dst).reset_zone(z)
                    new_zones = None
                    return False
                n = min(self.chunk_bytes, total - done)
                yield src_dev.read(n, random=False, tag="migr", background=True)
                rem = n
                while rem > 0:
                    zone = new_zones[zi]
                    take = min(rem, zone.remaining)
                    if take == 0:
                        zi += 1
                        continue
                    yield dst_dev.append(zone, take, tag="migr", background=True)
                    rem -= take
                done += n
                self.bytes_moved += n
                # rate limiting: pace the *aggregate* migration stream
                target = start + done / self.rate_limit
                if be.sim.now < target:
                    yield target - be.sim.now   # bare-delay: no Event
            if sst.locked or sst.sid not in be.ssts:
                self.aborted += 1
                for z in new_zones:
                    be.device_of(dst).reset_zone(z)
                new_zones = None
                return False
            be.relocate(sst, dst, new_zones)
            return True
        finally:
            sst.migrating = False
