"""HHZS middleware: bridges the LSM-tree KV store and hybrid zoned storage.

Owns both zoned devices, the zone organization of §3.2 (reserved WAL/cache
zones on the SSD, SST zones elsewhere), the WAL manager, and — when enabled —
the workload-aware migrator (§3.4) and application-hinted cache (§3.5).
Placement decisions are delegated to a ``PlacementPolicy`` (§3.3 / baselines).

SST sizing follows the paper: one SST fits a single SSD zone (93.9% of the
1077 MiB zone capacity) or spans four HDD zones.  All I/O paths are simulator
generators so queueing interference between foreground reads and background
flush/compaction/migration traffic is modelled faithfully.
"""
from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass
from typing import (Callable, Dict, FrozenSet, Generator, List, Optional,
                    Set, Tuple, TYPE_CHECKING, Union)

from ..zoned.device import MiB, Zone, ZonedDevice, ZoneState
from ..zoned.sim import Sim
from .hinted_cache import HintedCache
from .hints import CacheHint
from .migration import Migrator
from .placement import PlacementPolicy

if TYPE_CHECKING:
    from ..lsm.sstable import SST

SSD, HDD = "ssd", "hdd"
_CHUNK = int(1 * MiB)


class HybridZonedBackend:
    def __init__(self, sim: Sim, ssd: ZonedDevice, hdd: ZonedDevice,
                 placement: PlacementPolicy,
                 wal_cache_zones: int = 2,
                 block_size: int = 4096,
                 enable_migration: bool = False,
                 enable_cache: bool = False,
                 migration_rate: float = 4 * MiB,
                 io_chunk: int = int(1 * MiB),
                 basic_migration_low_levels: Optional[int] = None,
                 hdd_rate_window: float = 10.0):
        self.sim = sim
        self.ssd = ssd
        self.hdd = hdd
        self.placement = placement
        self.block_size = block_size
        self.io_chunk = io_chunk
        placement.attach(self)

        # ---- zone organization (§3.2) ---------------------------------
        self.reserve_zids: Set[int] = set()
        if placement.reserves_wal:
            carved = [ssd.alloc_zone("reserve-free")
                      for _ in range(wal_cache_zones)]
            for z in carved:
                # keep it EMPTY but remembered as reserved
                ssd.reset_zone(z)
                self.reserve_zids.add(z.zid)

        # ---- SST registry ----------------------------------------------
        self.ssts: Dict[int, "SST"] = {}
        self._ssd_level_counts: Dict[int, int] = defaultdict(int)

        # ---- WAL state --------------------------------------------------
        self._wal_records: List[dict] = []   # {zone, dev, gens:set}
        self._cur_wal: Optional[dict] = None
        # logical WAL payloads per MemTable generation — the replay source
        # for crash recovery (RocksDB: log records keyed by log number).
        # Dropped in wal_flushed() once the generation is durable as SSTs.
        self._wal_payloads: Dict[int, List[tuple]] = defaultdict(list)
        self._wal_waiters: List = []
        # WAL-full backpressure hook (the LSM-tree forces a memtable switch
        # + flush, as RocksDB does when max_total_wal_size is hit)
        self.wal_pressure_cb = None
        # group commit: concurrent writers batch into one WAL I/O
        self._wal_queue: "deque[tuple]" = deque()
        self._wal_writer_running = False

        # ---- optional components ---------------------------------------
        self.cache: Optional[HintedCache] = (
            HintedCache(self, block_size) if enable_cache else None)
        # dynamic cap on cache zones (repro_torch.obs.control's reservation
        # knob): None = unlimited (default, behaviour unchanged); an int
        # makes HintedCache refuse/evict beyond that many zones, freeing
        # reserved zones for the WAL under write pressure
        self.cache_zone_budget: Optional[int] = None
        self.migrator: Optional[Migrator] = (
            Migrator(self, rate_limit=migration_rate, chunk_bytes=io_chunk,
                     basic_low_levels=basic_migration_low_levels)
            if enable_migration else None)

        # ---- read-rate window for popularity migration ------------------
        self._hdd_window = hdd_rate_window
        self._hdd_buckets: Dict[int, int] = defaultdict(int)

        # ---- stats -------------------------------------------------------
        self.stats = defaultdict(float)

    def start(self) -> None:
        self.placement.start()
        if self.migrator is not None:
            self.migrator.start()

    # ==================================================================
    # zone pool queries used by placement / migration
    # ==================================================================
    def device_of(self, tier: str) -> ZonedDevice:
        return self.ssd if tier == SSD else self.hdd

    def zone_bytes(self, tier: str) -> int:
        return self.device_of(tier).zone_capacity

    def c_ssd(self) -> int:
        """SSD zones available for SSTs (total minus reserved WAL/cache)."""
        return len(self.ssd.zones) - len(self.reserve_zids)

    def ssd_has_empty_sst_zone(self) -> bool:
        return any(z.state == ZoneState.EMPTY and z.zid not in self.reserve_zids
                   for z in self.ssd.zones)

    def ssd_empty_sst_zones(self) -> int:
        return sum(1 for z in self.ssd.zones
                   if z.state == ZoneState.EMPTY and z.zid not in self.reserve_zids)

    def ssd_sst_count_at_level(self, level: int) -> int:
        return self._ssd_level_counts.get(level, 0)

    def ssd_ssts(self) -> List["SST"]:
        return [s for s in self.ssts.values() if s.tier == SSD]

    def hdd_ssts(self) -> List["SST"]:
        return [s for s in self.ssts.values() if s.tier == HDD]

    # ==================================================================
    # hint entry point (LSM-tree -> middleware)
    # ==================================================================
    def on_hint(self, hint) -> None:
        self.placement.on_hint(hint)

    # ==================================================================
    # SST I/O
    # ==================================================================
    def alloc_sst_zones(self, tier: str, size_bytes: int,
                        owner: str) -> Optional[List[Zone]]:
        dev = self.device_of(tier)
        need = -(-size_bytes // dev.zone_capacity)
        free = [z for z in dev.zones
                if z.state == ZoneState.EMPTY
                and (tier == HDD or z.zid not in self.reserve_zids)]
        if len(free) < need:
            return None
        zones = free[:need]
        for z in zones:
            z.state = ZoneState.OPEN
            z.owner = owner
        return zones

    def write_sst(self, sst: "SST", source: str):
        """Generator: place (per policy) and sequentially write a new SST."""
        tier = self.placement.choose_tier(sst.level, source)
        zones = self.alloc_sst_zones(tier, sst.size_bytes, f"sst:{sst.sid}")
        if zones is None and tier == SSD:
            tier = HDD
            zones = self.alloc_sst_zones(HDD, sst.size_bytes, f"sst:{sst.sid}")
        if zones is None:
            raise RuntimeError("HDD out of zones — size the simulation larger")
        sst.tier = tier
        sst.zones = zones
        sst.birth = self.sim.now
        self._register(sst)
        # lock while the write streams: the SST is registered (placement
        # must see its zones as allocated) but the migrator must not move
        # a half-written SST
        sst.locked = True
        try:
            yield from self._stream_to_zones(
                self.device_of(tier), list(zones), sst.size_bytes,
                tag=f"L{sst.level}")
        finally:
            sst.locked = False

    def _stream_to_zones(self, dev: ZonedDevice, zones: List[Zone],
                         total: int, tag: str, background: bool = False):
        """Generator: sequentially append ``total`` bytes across ``zones``
        in ``io_chunk``-sized requests (shared by SST writes and repairs)."""
        done = 0
        zi = 0
        while done < total:
            n = min(self.io_chunk, total - done)
            rem = n
            while rem > 0:
                zone = zones[zi]
                take = min(rem, zone.remaining)
                if take == 0:
                    zi += 1
                    continue
                yield dev.append(zone, take, tag=tag, background=background)
                rem -= take
            done += n

    def delete_sst(self, sst: "SST") -> None:
        """SST removed by compaction: reset its zones (space reclaim)."""
        self._unregister(sst)
        dev = self.device_of(sst.tier)
        for z in sst.zones:
            dev.reset_zone(z)
        sst.zones = []
        if self.cache is not None:
            self.cache.drop_sst(sst.sid)
        self._wake_wal_waiters()

    def relocate(self, sst: "SST", new_tier: str, new_zones: List[Zone]) -> None:
        """Migration finished: flip tiers, reset source zones."""
        old_dev = self.device_of(sst.tier)
        for z in sst.zones:
            old_dev.reset_zone(z)
        if sst.tier == SSD:
            self._ssd_level_counts[sst.level] -= 1
        sst.tier = new_tier
        sst.zones = new_zones
        if new_tier == SSD:
            self._ssd_level_counts[sst.level] += 1
            # cached copies of now-SSD-resident blocks are redundant
            if self.cache is not None:
                self.cache.drop_sst(sst.sid)
        self._wake_wal_waiters()

    def note_level_change(self, sst: "SST", new_level: int) -> None:
        if sst.tier == SSD:
            self._ssd_level_counts[sst.level] -= 1
            self._ssd_level_counts[new_level] += 1
        sst.level = new_level

    def _register(self, sst: "SST") -> None:
        self.ssts[sst.sid] = sst
        if sst.tier == SSD:
            self._ssd_level_counts[sst.level] += 1

    def _unregister(self, sst: "SST") -> None:
        self.ssts.pop(sst.sid, None)
        if sst.tier == SSD:
            self._ssd_level_counts[sst.level] -= 1

    # ------------------------------------------------------------------
    def read_block(self, sst: "SST", block_idx: int):
        """Generator: read one data block; SSD cache zones checked first.

        Charges device I/O only — logical-read accounting (``num_reads``,
        the §3.4 popularity signal) lives in the tree's read path so that
        block-cache *hits* count too; counting only here made fully
        cache-resident hot SSTs look cold to the migrator."""
        if sst.tier == HDD and self.cache is not None \
                and self.cache.lookup(sst.sid, block_idx):
            self.cache.record_hit()
            self.stats["ssd_cache_hits"] += 1
            yield self.ssd.io(self.block_size, "rand_read", tag="cache")
            return "ssd-cache"
        dev = self.device_of(sst.tier)
        if sst.tier == HDD:
            self._hdd_buckets[int(self.sim.now)] += 1
            self.stats["hdd_block_reads"] += 1
        else:
            self.stats["ssd_block_reads"] += 1
        yield dev.io(self.block_size, "rand_read", tag=f"L{sst.level}")
        return sst.tier

    def on_block_evicted(self, sst: Optional[SST], block_idx: int) -> None:
        """Cache hint (§3.5): fire-and-forget admission into cache zones."""
        if self.cache is None or sst is None:
            return
        self.on_hint(CacheHint(sst_id=sst.sid, block_idx=block_idx))
        self.sim.process(self.cache.admit(sst.sid, block_idx, sst.tier))

    def hdd_read_rate(self) -> float:
        """HDD block reads per second over a sliding window (§3.4 trigger).

        Averages the ``w`` most recent *complete* one-second buckets
        [now-w, now); the current second's partial bucket is excluded —
        counting it while dividing by the full window dilutes the rate and
        delays popularity migration right after a read burst.  Buckets that
        fell out of the window are pruned on every call, so the dict stays
        at ~w entries regardless of run length."""
        now = int(self.sim.now)
        w = max(int(self._hdd_window), 1)
        total = sum(self._hdd_buckets.get(now - i, 0) for i in range(1, w + 1))
        stale = [k for k in self._hdd_buckets if k < now - w]
        for k in stale:
            del self._hdd_buckets[k]
        return total / float(w)

    # ==================================================================
    # device fault handling (repro_torch.zoned.faults)
    # ==================================================================
    def on_zone_fault(self, tier: str, zone: Zone) -> None:
        """A zone was spontaneously reset by the device (torn zone).

        The host detects it (ZNS reports zone state) and repairs according
        to the owner: an SST zone keeps its allocation (so the allocator
        cannot hand it out while degraded) and the SST is re-replicated to
        fresh zones; a WAL zone's loss forces an immediate flush — the data
        still lives in the MemTables, flushing makes it durable again; a
        cache zone just drops its (clean-copy) mapping entries."""
        dev = self.device_of(tier)
        owner = zone.owner
        dev.reset_zone(zone)
        self.stats["zone_faults"] += 1
        if owner is None:
            return
        if owner == "wal":
            for rec in [r for r in self._wal_records if r["zone"] is zone]:
                self._wal_records.remove(rec)
                if rec is self._cur_wal:
                    self._cur_wal = None
            if self.wal_pressure_cb is not None:
                self.wal_pressure_cb()
            self._wake_wal_waiters()
        elif owner == "cache":
            if self.cache is not None:
                self.cache.on_zone_fault(zone)
            self._wake_wal_waiters()
        elif owner.startswith("sst:"):
            sst = self.ssts.get(int(owner.split(":", 1)[1]))
            if sst is None:
                return
            # keep the torn zone allocated to its SST while the repair runs
            # (a reset zone is EMPTY and the allocator would hand it out,
            # leaving two owners); the repair's relocate() resets it anyway
            zone.state = ZoneState.OPEN
            zone.owner = owner
            self.sim.process(self._repair_sst(sst))

    def _repair_sst(self, sst: "SST"):
        """Generator: re-create a full replacement copy of a degraded SST
        (as a production deployment would from a replica), then swap."""
        # wait out a compaction/migration holding the SST: compaction will
        # delete it, migration rewrites it — either resolves the torn zone
        while sst.locked or sst.migrating:
            if self.ssts.get(sst.sid) is not sst:
                return
            yield self.sim.timeout(0.25, daemon=True)
        if self.ssts.get(sst.sid) is not sst:
            return
        tier = sst.tier
        zones = self.alloc_sst_zones(tier, sst.size_bytes, f"sst:{sst.sid}")
        if zones is None:
            tier = HDD if tier == SSD else SSD
            zones = self.alloc_sst_zones(tier, sst.size_bytes,
                                         f"sst:{sst.sid}")
        if zones is None:
            self.stats["unrepaired_sst_faults"] += 1
            return
        sst.locked = True
        try:
            src = self.device_of(sst.tier)
            rem = sst.size_bytes
            while rem > 0:
                n = min(self.io_chunk, rem)
                yield src.read(n, random=False, tag="repair", background=True)
                rem -= n
            yield from self._stream_to_zones(self.device_of(tier), zones,
                                             sst.size_bytes, tag="repair",
                                             background=True)
        finally:
            sst.locked = False
        if self.ssts.get(sst.sid) is not sst:
            for z in zones:   # compacted away mid-repair: give zones back
                self.device_of(tier).reset_zone(z)
            return
        self.relocate(sst, tier, zones)
        self.stats["repaired_ssts"] += 1

    # ==================================================================
    # crash / recovery (DB.crash() / DB.reopen())
    # ==================================================================
    def crash_volatile(self) -> None:
        """Crash: the in-memory WAL machinery dies with the process; zones,
        records and per-generation payloads are durable and survive."""
        self._wal_waiters = []
        self._wal_queue = deque()
        self._wal_writer_running = False
        # recovery starts a fresh WAL zone (RocksDB starts a new log file)
        self._cur_wal = None

    def reopen_rebuild(self, ssts: List["SST"]) -> None:
        """Recovery: rebuild the SST registry, ``_ssd_level_counts`` and the
        zone map from durable state.

        ``ssts`` is the manifest — the SSTs that were durably installed at
        crash time.  Every non-empty zone not referenced by an installed
        SST or a live WAL record is garbage from in-flight work (partial
        SST writes, compaction outputs, migration/repair destinations,
        cache fills) and is reset; this single rule is the whole zone-map
        rebuild."""
        self.ssts = {}
        self._ssd_level_counts = defaultdict(int)
        for sst in ssts:
            sst.locked = False
            sst.migrating = False
            self._register(sst)
        # WAL records whose generations all flushed are dead weight
        self._wal_records = [r for r in self._wal_records if r["gens"]]
        live = {id(z) for s in ssts for z in s.zones}
        live |= {id(r["zone"]) for r in self._wal_records}
        for dev in (self.ssd, self.hdd):
            for z in dev.zones:
                if z.state != ZoneState.EMPTY and id(z) not in live:
                    dev.reset_zone(z)
        # the hinted cache's mapping table is in-memory: cold after restart
        if self.cache is not None:
            self.cache.clear_volatile()
        self.placement.on_reopen()

    # ==================================================================
    # WAL manager
    # ==================================================================
    def wal_zones_in_use(self) -> int:
        return len(self._wal_records)

    def wal_pressure(self) -> bool:
        """True while at least one writer is stalled waiting for a WAL zone.

        This is the overload signal the admission controller keys on: WAL
        stalls mean the flush pipeline cannot keep up with the offered write
        rate, so shedding (or delaying) new work is the only way to bound
        the queueing delay of tenants that must meet an SLO."""
        return bool(self._wal_waiters)

    def acquire_reserved_zone(self, kind: str) -> Optional[Zone]:
        for z in self.ssd.zones:
            if z.zid in self.reserve_zids and z.state == ZoneState.EMPTY:
                z.state = ZoneState.OPEN
                z.owner = kind
                return z
        return None

    def release_reserved_zone(self, zone: Zone) -> None:
        self.ssd.reset_zone(zone)
        self._wake_wal_waiters()

    def _wal_new_zone(self) -> Optional[dict]:
        if self.placement.reserves_wal:
            zone = self.acquire_reserved_zone("wal")
            if zone is None and self.cache is not None and self.cache.zones:
                # WAL pressure evicts cache zones (§3.5 cache eviction)
                self.cache.evict_oldest_zone()
                zone = self.acquire_reserved_zone("wal")
            if zone is None:
                return None
            dev = self.ssd
        else:
            # basic schemes: any empty SSD zone, else HDD (§2.3)
            zone = None
            for z in self.ssd.zones:
                if z.state == ZoneState.EMPTY:
                    zone, dev = z, self.ssd
                    break
            if zone is None:
                for z in self.hdd.zones:
                    if z.state == ZoneState.EMPTY:
                        zone, dev = z, self.hdd
                        break
            if zone is None:
                return None
            zone.state = ZoneState.OPEN
            zone.owner = "wal"
        rec = {"zone": zone, "dev": dev, "gens": set()}
        self._wal_records.append(rec)
        return rec

    def wal_append(self, nbytes: int):
        """Generator: append a log record (group-committed with concurrent
        writers, as RocksDB batches WAL writes from its write group).

        Returns the WAL zone records the batch landed in; the caller
        attributes its MemTable generation to them *after* inserting
        (attribution at enqueue time is wrong: the memtable can rotate —
        or even flush — while the write sits in the group-commit queue,
        leaving phantom generations that pin WAL zones forever)."""
        ev = self.sim.event()
        self._wal_queue.append((nbytes, ev))
        if not self._wal_writer_running:
            self._wal_writer_running = True
            self.sim.process(self._wal_writer())
        records = yield ev
        return records

    def wal_attribute(self, records, gen: int, key: Optional[int] = None,
                      tomb: bool = False, value: Optional[bytes] = None,
                      tenant: Optional[str] = None) -> None:
        """Attribute a group-committed batch's bytes to MemTable generation
        ``gen`` and log the logical record for crash replay.

        The payload is the durable mirror of the MemTable insert that just
        happened: on ``DB.reopen()`` the live generations' payloads are
        replayed back into fresh MemTables, in the original insert order.
        ``tenant`` rides along so replay rebuilds the per-tenant
        debt-attribution tallies (``MemTable.tenant_objs``) too."""
        for rec in records:
            rec["gens"].add(gen)
        if key is not None:
            self._wal_payloads[gen].append((key, tomb, value, tenant))

    def _wal_writer(self):
        try:
            while self._wal_queue:
                # bounded group commit: one batch never exceeds a WAL
                # zone's capacity.  An unbounded batch deadlocks under
                # bursts: writers are only acknowledged (and their data
                # only inserted into MemTables) once the WHOLE batch is on
                # stable storage, so a batch larger than the total WAL
                # space would wait forever for zones that can only be
                # freed by flushing data the batch itself still holds.
                # Basic schemes can spill the WAL to HDD zones (smaller),
                # so bound by the smallest device that may host it.
                if self.placement.reserves_wal:
                    cap = max(self.ssd.zone_capacity, 1)
                else:
                    cap = max(min(self.ssd.zone_capacity,
                                  self.hdd.zone_capacity), 1)
                batch: List[tuple] = []
                total = 0
                while self._wal_queue and \
                        (not batch or total + self._wal_queue[0][0] <= cap):
                    n, ev = self._wal_queue.popleft()
                    batch.append((n, ev))
                    total += n
                touched = []
                while total > 0:
                    rec = self._cur_wal
                    if rec is None or rec["zone"].remaining <= 0:
                        rec = self._wal_new_zone()
                        if rec is None:
                            # stall until a flush or zone reset frees WAL
                            # space; signal pressure so the tree force-flushes
                            if self.wal_pressure_cb is not None:
                                self.wal_pressure_cb()
                            ev = self.sim.event()
                            self._wal_waiters.append(ev)
                            self.stats["wal_stalls"] += 1
                            yield ev
                            continue
                        self._cur_wal = rec
                    take = min(total, rec["zone"].remaining)
                    if rec not in touched:
                        touched.append(rec)
                    yield rec["dev"].append(rec["zone"], take, tag="wal")
                    total -= take
                for _, ev in batch:
                    ev.succeed(touched)
        finally:
            self._wal_writer_running = False

    def wal_flushed(self, gens: Set[int]) -> None:
        """MemTable generations persisted as SSTs: their WAL data is dead."""
        for g in gens:
            self._wal_payloads.pop(g, None)
        kept = []
        for rec in self._wal_records:
            rec["gens"] -= gens
            full = rec["zone"].remaining <= 0
            # the current zone is also reclaimable once it is full + dead
            reclaim = not rec["gens"] and (rec is not self._cur_wal or full)
            if reclaim:
                if rec is self._cur_wal:
                    self._cur_wal = None
                if self.placement.reserves_wal:
                    self.release_reserved_zone(rec["zone"])
                else:
                    rec["dev"].reset_zone(rec["zone"])
            else:
                kept.append(rec)
        self._wal_records = kept
        self._wake_wal_waiters()

    def _wake_wal_waiters(self) -> None:
        waiters, self._wal_waiters = self._wal_waiters, []
        for ev in waiters:
            ev.succeed()

    # ==================================================================
    # telemetry (repro_torch.obs) — pull gauges only: zero hot-path overhead
    # ==================================================================
    def install_metrics(self, reg, prefix: str = "") -> None:
        """Register the middleware's signals on a ``MetricsRegistry``.

        Every signal maps to a paper hint family (§3.1): WAL pressure and
        zone counts are the flush-side backpressure (§3.2 zone
        organization), migration traffic is the §3.4 migrator at work,
        cache hit rate is the §3.5 hinted cache paying off.  ``prefix``
        namespaces the series per shard (``s{i}.mw.*``) when the sharded
        cluster facade installs several backends on one registry.
        """
        p = prefix
        reg.gauge(f"{p}mw.wal_pressure", lambda: float(self.wal_pressure()))
        reg.gauge(f"{p}mw.wal_zones", lambda: float(self.wal_zones_in_use()))
        reg.gauge(f"{p}mw.wal_stalls", lambda: self.stats["wal_stalls"])
        reg.gauge(f"{p}mw.hdd_read_rate", self.hdd_read_rate)
        if self.cache is not None:
            reg.gauge(f"{p}mw.cache_hits", lambda: float(self.cache.hits))
            reg.gauge(f"{p}mw.cache_zones",
                      lambda: float(len(self.cache.zones)))
        if self.migrator is not None:
            reg.gauge(f"{p}mw.migrated_bytes",
                      lambda: float(self.migrator.bytes_moved))
            # migration traffic as a windowed rate (bytes/s between samples)
            reg.collector(lambda: {
                f"{p}mw.migration_rate": float(self.migrator.bytes_moved)},
                rate=True, name=f"{p}mw.migration_rate")


# ======================================================================
# admission control / load shedding (multi-tenant serving)
# ======================================================================
ADMIT, REJECT, DELAY = "admit", "reject", "delay"

ADMISSION_POLICIES = ("none", "reject", "delay", "token_bucket", "feedback")


@dataclass
class AdmissionConfig:
    """Configuration of the per-tenant admission controller.

    policy
        ``none``          admit everything (baseline).
        ``reject``        shed non-protected ops while the store is under
                          pressure (WAL stall or service backlog) — the op
                          is dropped before it ever queues.
        ``delay``         hold non-protected ops while under pressure and
                          admit them once the pressure clears (classic
                          delay-at-WAL-pressure: offered work is deferred,
                          not lost).
        ``token_bucket``  per-tenant token bucket: ops above a tenant's
                          sustained ``rate`` (with ``burst`` headroom) are
                          shed regardless of store pressure.
        ``feedback``      per-tenant token bucket whose rates are *driven*
                          by the SLO feedback controller
                          (``repro_torch.obs.control.ControlPlane``): AIMD over
                          the non-protected tenants' rates, keyed on the
                          protected tenants' measured p99 vs their
                          ``TenantSpec.slo_p99`` targets and on compaction
                          debt vs ``debt_threshold``.
    protected
        Tenant names exempt from shedding/delaying under every policy —
        the SLO tenants the middleware exists to protect.
    queue_threshold
        Service-backlog gauge threshold: when a runner registers a queue
        gauge (see ``AdmissionController.queue_gauge``), a backlog above
        this count also counts as pressure.
    poll_interval
        Virtual seconds between pressure re-checks while a delayed op is
        held.
    bucket_rate / bucket_burst / bucket_rates
        Default token-bucket parameters (tokens/virtual-second, bucket
        size) and optional per-tenant ``{name: (rate, burst)}`` overrides.
        The default rate is infinite, i.e. tenants without an explicit
        budget are not rate-limited.  Bursts are normalized to >= 1.0
        token: admitting one op costs one full token, so a bucket smaller
        than one token could never admit anything — the tenant would be
        starved forever regardless of its configured rate.
    debt_threshold
        Compaction-debt pressure signal (bytes): when set and the
        controller has a ``debt_gauge`` (wired by ``DB`` / the runners to
        ``LSMTree.compaction_debt``), debt above this threshold counts as
        pressure for the ``reject``/``delay`` policies and as an
        over-target condition for the ``feedback`` controller — shedding
        starts while the debt is building, before it turns into write
        stalls.
    label
        Optional display name for result rows / cell names, so two cells
        sharing a policy kind but different parameters (e.g. ``reject``
        with and without ``debt_threshold``) stay distinguishable.
    feedback_interval / feedback_window / feedback_decrease /
    feedback_increase / feedback_headroom / feedback_floor
        Constants of the ``feedback`` policy's AIMD loop
        (``repro_torch.obs.control.ControlPlane``): control period in virtual
        seconds, per-tenant latency samples for the p99 estimate,
        multiplicative decrease factor, additive increase step and rate
        floor (both as fractions of the tenant's base rate), and the
        p99/target ratio below which additive increase engages.
    feedback_controller
        Which control law drives the ``feedback`` policy's knobs:
        ``"aimd"`` (default, the PR-5 loop unchanged) or ``"pi"`` — a
        proportional-integral controller with anti-windup
        (``repro_torch.obs.control.PIController``) on the worst protected
        p99/target ratio, emitting one smooth admission multiplier
        instead of AIMD's sawtooth.
    feedback_knobs
        Which actuators the control plane drives (any subset of
        ``repro_torch.obs.control.KNOBS``): ``"admission"`` (per-tenant
        token-bucket rates — the only PR-5 knob), ``"compaction"``
        (SILK-style pacing of background compaction I/O via
        ``LSMTree.compaction_pace``), ``"migration"`` (scaling
        ``Migrator.rate_limit``), ``"cache"`` (the backend's
        ``cache_zone_budget``).  Defaults to admission-only, matching v1.
    feedback_kp / feedback_ki
        PI gains (per unit of p99/target ratio error); only read when
        ``feedback_controller == "pi"``.
    feedback_smooth
        EWMA smoothing factor in (0, 1] applied to the noisy per-tick
        p99/target measurement before the PI law sees it (1 = unsmoothed).
    feedback_rise
        Optional slew-rate limit on the PI actuation level's *recovery*
        (max increase of ``u`` per control period; ``None`` = unlimited).
        Throttling down stays unlimited — pressure must be cut within
        one period — but bounding the climb back keeps a high-gain PI
        from re-admitting a burst the moment one good p99 window lands
        (the overshoot half of the limit cycle).
    """

    policy: str = "none"
    protected: FrozenSet[str] = frozenset()
    queue_threshold: int = 128
    poll_interval: float = 0.5
    bucket_rate: float = float("inf")
    bucket_burst: float = 1.0
    bucket_rates: Optional[Dict[str, Tuple[float, float]]] = None
    debt_threshold: Optional[float] = None
    label: Optional[str] = None
    feedback_interval: float = 5.0
    feedback_window: int = 200
    feedback_decrease: float = 0.7
    feedback_increase: float = 0.08
    feedback_headroom: float = 0.8
    feedback_floor: float = 0.02
    feedback_controller: str = "aimd"
    feedback_knobs: Tuple[str, ...] = ("admission",)
    feedback_kp: float = 0.6
    feedback_ki: float = 0.15
    feedback_smooth: float = 0.5
    feedback_rise: Optional[float] = None

    def __post_init__(self):
        self.bucket_burst = max(float(self.bucket_burst), 1.0)
        if self.bucket_rates:
            self.bucket_rates = {
                t: (rate, max(float(burst), 1.0))
                for t, (rate, burst) in self.bucket_rates.items()}
        self.feedback_knobs = tuple(self.feedback_knobs)
        if self.feedback_controller not in ("aimd", "pi"):
            raise ValueError("feedback_controller must be 'aimd' or 'pi', "
                             f"got {self.feedback_controller!r}")


class AdmissionController:
    """Admission-control / load-shedding layer in front of the KV store.

    Sits between request arrival and the store's service queue (wired
    through ``DB.submit(gen, tenant=...)`` and the open-loop multi-tenant
    runner).  Each arriving op is attributed to a named tenant and gets one
    of three verdicts from :meth:`decide`:

    * ``ADMIT``  — enqueue for service now,
    * ``REJECT`` — shed (the op never executes; conserved in counters),
    * ``DELAY``  — hold via :meth:`hold` until pressure clears, then admit.

    Pressure (:meth:`under_pressure`) is WAL back-pressure from the
    middleware (``HybridZonedBackend.wal_pressure``) OR a service backlog
    reported by an attached ``queue_gauge`` (the open-loop runner registers
    its queue depth).  Protected tenants are always admitted.

    Per-tenant counters (``counters[name]``):
      ``arrived``   ops that reached the controller,
      ``admitted``  ops enqueued for service (including after a hold),
      ``rejected``  ops shed,
      ``delayed``   ops that entered a hold,
      ``holding``   ops currently held (0 after a drained run),
      ``delay_time`` total virtual seconds spent in holds.
    Conservation: ``arrived == admitted + rejected + holding`` at all times.
    """

    def __init__(self, sim: Sim, backend: Optional[HybridZonedBackend] = None,
                 cfg: Union[AdmissionConfig, str, None] = None):
        if cfg is None:
            cfg = AdmissionConfig()
        elif isinstance(cfg, str):
            cfg = AdmissionConfig(policy=cfg)
        if cfg.policy not in ADMISSION_POLICIES:
            raise ValueError(f"unknown admission policy {cfg.policy!r}; "
                             f"one of {ADMISSION_POLICIES}")
        self.sim = sim
        self.backend = backend
        self.cfg = cfg
        # pristine config as handed in: runners rebind self.cfg (e.g. to
        # widen `protected` for one run) but never touch base_cfg, so a
        # fresh per-run controller can always be rebuilt from it
        self.base_cfg = cfg
        # service-backlog gauge, registered by the open-loop runner:
        # () -> current queue depth
        self.queue_gauge: Optional[Callable[[], int]] = None
        # compaction-debt gauge (bytes), wired by DB / the runners to
        # LSMTree.compaction_debt; consulted only when cfg.debt_threshold
        # is set — the third pressure signal
        self.debt_gauge: Optional[Callable[[], float]] = None
        # shard-scoped pressure signals (repro_torch.cluster): one () -> bool
        # callable per shard, typically that shard backend's wal_pressure.
        # Any shard under pressure puts the cluster controller under
        # pressure — a hot shard sheds/delays for the whole cluster, since
        # routed ops cannot know in advance which shard they will hit.
        self.shard_pressure: List[Callable[[], bool]] = []
        # live token-bucket rate overrides, driven by the SLO feedback
        # controller (repro_torch.obs.control.ControlPlane) under policy
        # "feedback"; consulted before cfg.bucket_rates
        self.rate_overrides: Dict[str, float] = {}
        self.counters: Dict[str, Dict[str, float]] = {}
        self._buckets: Dict[str, List[float]] = {}   # name -> [tokens, t]

    # ------------------------------------------------------------------
    def tenant_counters(self, tenant: str) -> Dict[str, float]:
        c = self.counters.get(tenant)
        if c is None:
            c = self.counters[tenant] = {
                "arrived": 0, "admitted": 0, "rejected": 0,
                "delayed": 0, "holding": 0, "delay_time": 0.0}
        return c

    def under_pressure(self) -> bool:
        if self.backend is not None and self.backend.wal_pressure():
            return True
        if any(p() for p in self.shard_pressure):
            return True
        g = self.queue_gauge
        if g is not None and g() > self.cfg.queue_threshold:
            return True
        d = self.debt_gauge
        return (d is not None and self.cfg.debt_threshold is not None
                and d() > self.cfg.debt_threshold)

    def shard_under_pressure(self) -> List[bool]:
        """Per-shard pressure snapshot (empty for single-store
        controllers); exposed for telemetry and the cluster rebalancer."""
        return [bool(p()) for p in self.shard_pressure]

    # ------------------------------------------------------------------
    def decide(self, tenant: str) -> str:
        """Admission verdict for one arriving op of ``tenant``."""
        c = self.tenant_counters(tenant)
        c["arrived"] += 1
        pol = self.cfg.policy
        if pol == "none" or tenant in self.cfg.protected:
            c["admitted"] += 1
            return ADMIT
        if pol == "token_bucket" or pol == "feedback":
            if self._take_token(tenant):
                c["admitted"] += 1
                return ADMIT
            c["rejected"] += 1
            return REJECT
        if not self.under_pressure():
            c["admitted"] += 1
            return ADMIT
        if pol == "reject":
            c["rejected"] += 1
            return REJECT
        c["delayed"] += 1
        c["holding"] += 1
        return DELAY

    def hold(self, tenant: str) -> Generator:
        """Generator: park a DELAY-ed op until pressure clears (polling
        every ``poll_interval`` virtual seconds), then count it admitted."""
        c = self.tenant_counters(tenant)
        t0 = self.sim.now
        while self.under_pressure():
            yield self.cfg.poll_interval   # bare-delay sleep
        c["delay_time"] += self.sim.now - t0
        c["holding"] -= 1
        c["admitted"] += 1

    def _take_token(self, tenant: str) -> bool:
        rates = self.cfg.bucket_rates or {}
        rate, burst = rates.get(tenant,
                                (self.cfg.bucket_rate, self.cfg.bucket_burst))
        ov = self.rate_overrides.get(tenant)
        if ov is not None:
            rate = ov
        if rate == float("inf"):
            return True
        now = self.sim.now
        b = self._buckets.get(tenant)
        if b is None:
            b = self._buckets[tenant] = [float(burst), now]
        tokens = min(float(burst), b[0] + (now - b[1]) * rate)
        b[1] = now
        if tokens >= 1.0:
            b[0] = tokens - 1.0
            return True
        b[0] = tokens
        return False

    # ------------------------------------------------------------------
    def submit(self, gen: Generator, tenant: str):
        """``DB.submit`` facade: schedule ``gen`` subject to admission.

        Returns the scheduled Process, or ``None`` when the op was shed
        (the generator is closed without running)."""
        verdict = self.decide(tenant)
        if verdict == REJECT:
            gen.close()
            return None
        if verdict == DELAY:
            def held():
                yield from self.hold(tenant)
                result = yield from gen
                return result
            return self.sim.process(held())
        return self.sim.process(gen)

    def admission_summary(self, tenant: str) -> Dict[str, float]:
        """JSON-ready per-tenant admission counters (row schema field)."""
        c = dict(self.tenant_counters(tenant))
        c["mean_delay"] = (c["delay_time"] / c["delayed"]
                           if c["delayed"] else 0.0)
        return c

    @property
    def policy_label(self) -> str:
        """Display name for rows/cells: ``cfg.label`` or the policy kind."""
        return self.cfg.label or self.cfg.policy

    # ------------------------------------------------------------------
    def install_metrics(self, reg) -> None:
        """Per-tenant arrival/admit/reject *rates* (ops/s between samples)
        on a ``MetricsRegistry``.  Collector-based because tenants appear
        lazily (the key set grows as tenants send their first op)."""
        def _collect() -> Dict[str, float]:
            out: Dict[str, float] = {}
            for t, c in self.counters.items():
                out[f"adm.{t}.arrived"] = c["arrived"]
                out[f"adm.{t}.admitted"] = c["admitted"]
                out[f"adm.{t}.rejected"] = c["rejected"]
            return out

        reg.collector(_collect, rate=True, name="adm.tenants")
        reg.gauge("adm.pressure", lambda: float(self.under_pressure()))
        if self.shard_pressure:
            # per-shard pressure gauges: which shard is pushing back
            def _shards() -> Dict[str, float]:
                return {f"adm.s{i}.pressure": float(p())
                        for i, p in enumerate(self.shard_pressure)}
            reg.collector(_shards, name="adm.shard_pressure")
