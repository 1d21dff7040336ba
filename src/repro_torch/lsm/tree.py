"""Simulated LSM-tree KV store (RocksDB-flavoured, §2.2) issuing hints.

Structure: an active MemTable + immutable MemTables (flush when >=
``min_flush_memtables``, stall writes beyond ``max_memtables``), a WAL on
zoned storage via the middleware, levels L0..Ln with exponentially growing
target sizes, leveled compaction (one Li SST merged with the overlapping
Li+1 SSTs; L0 compacts all files because of overlapping ranges), Bloom
filters, and an in-memory LRU block cache whose evictions emit cache hints.

All read/write paths are simulator generators so that device time (and
interference with background jobs) is accounted per operation.

Bloom probes run on a torch device (``torch_device``, the CUDA card by
default): each level's concatenated filter image is uploaded once per
membership epoch, and the levels' images joined into one store image with
a slot table, which stays resident there.  A batched read ships its raw
keys and each (key x candidate SST) pair's key index, slot and k, and
brings back a hit mask: one probe call for all its levels, keys hashed on
the card.  A per-key read makes one call for all its levels.  Under
``LSMConfig.filter_impl="numpy"`` the same calls run on the host.
"""
from __future__ import annotations

from bisect import bisect_right
from itertools import accumulate
from dataclasses import dataclass, field
from typing import Dict, Generator, List, Optional, Set, Tuple

import numpy as np
import torch

from ..core.hints import (CompactionDoneHint, CompactionOutputHint,
                          CompactionTriggerHint, FlushHint)
from ..core.middleware import HybridZonedBackend
from ..zoned.sim import Semaphore, Sim
from . import filters
from .block_cache import BlockCache
from .sstable import SST, merge_runs


@dataclass
class LSMConfig:
    obj_size: int = 1024                 # 24 B key + 1000 B value
    block_size: int = 4096
    sst_size: int = int(1.0112 * (1 << 20))   # scaled 1011.2 MiB -> 1.0112 MiB
    memtable_size: int = int(0.512 * (1 << 20))
    min_flush_memtables: int = 2
    max_memtables: int = 4
    level_targets: Tuple[int, ...] = ()  # bytes per level; set by scenario
    num_levels: int = 5
    bloom_fp_rate: float = 0.01          # injected-FP oracle mode only
    # Bloom filter mode: "real" builds packed bit arrays per SST
    # (repro_torch.lsm.filters, splitmix64-unified with the bloom_probe
    # kernel);
    # "injected" keeps the synthetic-FP differential oracle
    filters: str = "real"
    filter_bits_per_key: int = 10
    # probe route: "torch" (default; filter images on the tree's
    # torch_device, probed by the bloom_probe kernel on a CUDA device or
    # its plain PyTorch version on the CPU) or "numpy" (host) — all
    # bit-identical
    filter_impl: str = "torch"
    block_cache_blocks: int = 8
    max_background_jobs: int = 12
    l0_stall_files: int = 36
    # RocksDB-style write throttling: slow writes when L0 piles up or the
    # pending compaction debt grows (scaled from the 64 GiB default)
    l0_slowdown_files: int = 20
    soft_pending_bytes: int = int(64 * (1 << 20))
    delayed_write_rate: float = 16 * (1 << 20)   # bytes/s, auto-adjusted
    store_values: bool = False

    @property
    def sst_max_objs(self) -> int:
        return max(1, self.sst_size // self.obj_size)

    @property
    def memtable_max_objs(self) -> int:
        return max(1, self.memtable_size // self.obj_size)

    def target_of(self, level: int) -> int:
        if level < len(self.level_targets):
            return self.level_targets[level]
        # default: 1 GiB-scaled L0/L1 then 10x per level
        base = self.level_targets[-1] if self.level_targets else self.sst_size
        return base * (10 ** (level - len(self.level_targets) + 1))


@dataclass
class MemTable:
    gen: int
    data: Dict[int, Tuple[bool, Optional[bytes]]] = field(default_factory=dict)
    # debt-attribution lineage: write volume into this memtable, total and
    # per originating tenant (puts without a tenant only bump ``writes``)
    writes: int = 0
    tenant_objs: Dict[str, int] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.data)


class LSMTree:
    def __init__(self, sim: Sim, cfg: LSMConfig, backend: HybridZonedBackend,
                 torch_device: str = "cuda"):
        self.sim = sim
        self.cfg = cfg
        filters.resolve_impl(cfg.filter_impl)
        # where the level filter images live and the probes run; a CUDA
        # device that is missing fails here, never falls back to the CPU
        self.torch_device = torch.device(torch_device)
        if (cfg.filter_impl == "torch" and self.torch_device.type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError(
                f"torch_device={torch_device!r} but CUDA is not available; "
                "pass torch_device='cpu' to probe on the CPU")
        self.backend = backend
        self.memtable = MemTable(gen=0)
        self.immutables: List[MemTable] = []
        self.levels: List[List[SST]] = [[] for _ in range(cfg.num_levels + 2)]
        # the MANIFEST: durably-installed SSTs (sid -> SST).  RocksDB logs
        # every install/delete to a synced MANIFEST file; this dict is its
        # in-sim equivalent — DB.reopen() rebuilds the store from it, and
        # anything registered but not installed here is lost in a crash.
        self.manifest: Dict[int, SST] = {}
        self._next_sst = 0
        self._next_cid = 0
        self.jobs = Semaphore(sim, cfg.max_background_jobs)
        self._stall_waiters: List = []
        self._flush_running = False
        self._force_flush = False
        self._wal_pressure = False
        self._flushing: List[MemTable] = []   # readable until SSTs install
        self._flush_watchers: List = []
        backend.wal_pressure_cb = self._on_wal_pressure
        self._rr_key: Dict[int, int] = {}    # round-robin compaction cursor
        self._level_bytes: List[int] = [0] * (cfg.num_levels + 2)
        # delayed-write controller (RocksDB WriteController flavour)
        self._delay_rate = float(cfg.delayed_write_rate)
        self._next_delayed_write = 0.0
        self._debt_prev = 0.0
        sim.process(self._delay_controller())
        # SILK-style compaction pacing knob (repro_torch.obs.control):
        # background compaction I/O beyond L0 is stretched by 1/pace,
        # deferring debt work under foreground pressure.  1.0 = full speed
        # (no extra yields, so default behaviour is event-for-event
        # unchanged).
        self.compaction_pace = 1.0
        self.block_cache = BlockCache(cfg.block_cache_blocks, self._on_evict)
        self.stats: Dict[str, float] = {
            "puts": 0, "gets": 0, "hits": 0, "scans": 0,
            "write_stalls": 0, "compactions": 0, "flushes": 0,
            "bloom_fp": 0, "filter_probes": 0, "delayed_writes": 0,
        }
        # per-level read index (sorted candidate arrays + concatenated
        # filter image), rebuilt lazily whenever the level's membership
        # epoch moves — see _level_index
        self._level_epoch: List[int] = [0] * (cfg.num_levels + 2)
        self._ridx: Dict[int, Tuple] = {}
        self._simg: Optional[Tuple] = None   # see _store_image
        self._prober = filters.Prober()
        # probe calls of the batched read: one per batch with a filtered
        # pair, plus the levels re-probed at walk time (see get_batch);
        # kept apart from ``stats``, which stay the reference's
        self.probe_calls: Dict[str, int] = {
            "batch": 0, "reprobe_epoch": 0, "reprobe_mixed_k": 0}

    # ------------------------------------------------------------------
    def _on_evict(self, sst_id: int, block_idx: int) -> None:
        sst = self.backend.ssts.get(sst_id)
        self.backend.on_block_evicted(sst, block_idx)

    def _new_sst_id(self) -> int:
        self._next_sst += 1
        return self._next_sst

    def level_size(self, level: int) -> int:
        return self._level_bytes[level]

    def level_sizes(self) -> List[int]:
        return list(self._level_bytes)

    def _install_sst(self, sst: SST, level: int) -> None:
        self.levels[level].append(sst)
        self._level_bytes[level] += sst.size_bytes
        self.manifest[sst.sid] = sst
        self._level_epoch[level] += 1

    def _remove_sst(self, sst: SST) -> None:
        self.levels[sst.level].remove(sst)
        self._level_bytes[sst.level] -= sst.size_bytes
        self.manifest.pop(sst.sid, None)
        self._level_epoch[sst.level] += 1

    def compaction_debt(self) -> int:
        return sum(max(0, self._level_bytes[l] - self.cfg.target_of(l))
                   for l in range(self.cfg.num_levels))

    def debt_by_tenant(self) -> Dict[str, float]:
        """Per-tenant attribution of :meth:`compaction_debt`.

        Each over-target level's overflow is split by the level's tenant
        byte composition (carried on SSTs through the flush -> compaction
        lineage); bytes written without a tenant tag land in the ``""``
        bucket.  By construction ``sum(values()) == compaction_debt()`` up
        to float rounding — the conservation law the controller (and
        ``tests/test_control_v2.py``) relies on."""
        out: Dict[str, float] = {}
        for lvl in range(self.cfg.num_levels):
            total = self._level_bytes[lvl]
            over = total - self.cfg.target_of(lvl)
            if over <= 0 or total <= 0:
                continue
            attr: Dict[str, float] = {}
            for s in self.levels[lvl]:
                for t, b in getattr(s, "tenant_bytes", {}).items():
                    attr[t] = attr.get(t, 0.0) + b
            tagged = 0.0
            for t, b in attr.items():
                share = over * (b / total)
                out[t] = out.get(t, 0.0) + share
                tagged += share
            rest = over - tagged
            if rest > 0:
                out[""] = out.get("", 0.0) + rest
        return out

    def _delay_controller(self):
        """Adapt the delayed write rate to whether compactions keep up."""
        while True:
            yield self.sim.timeout(1.0, daemon=True)
            debt = self.compaction_debt()
            throttling = (debt > self.cfg.soft_pending_bytes
                          or len(self.levels[0]) >= self.cfg.l0_slowdown_files)
            if throttling and debt >= self._debt_prev:
                self._delay_rate = max(self._delay_rate * 0.7,
                                       self.cfg.delayed_write_rate / 16.0)
            elif debt < self._debt_prev:
                self._delay_rate = min(self._delay_rate * 1.4,
                                       float(self.cfg.delayed_write_rate))
            self._debt_prev = debt

    def total_objs(self) -> int:
        n = sum(len(m) for m in [self.memtable] + self.immutables)
        n += sum(s.num_objs for lvl in self.levels for s in lvl)
        return n

    def write_amplification(self) -> float:
        """Device write bytes per user byte (WAL + flush + compaction +
        migration traffic over ``puts * obj_size``) — the governing
        backpressure quantity of the LSM design space."""
        user = self.stats["puts"] * self.cfg.obj_size
        if user <= 0:
            return 0.0
        dev = (self.backend.ssd.counters.write_bytes
               + self.backend.hdd.counters.write_bytes)
        return dev / user

    # ------------------------------------------------------------------
    # telemetry (repro_torch.obs) — pull gauges over state the tree already
    # maintains; the put/get/flush/compaction hot paths are untouched
    # ------------------------------------------------------------------
    def install_metrics(self, reg, prefix: str = "") -> None:
        """Register the tree's signals on a ``MetricsRegistry``.  These are
        the §3.1 hint quantities as continuous series: compaction debt and
        L0 depth (compaction hints), flush backlog (flush hints), write
        amplification and the delayed-write controller's rate.  Re-invoked
        by ``DB.reopen()`` so the gauges rebind to the recovered tree.
        ``prefix`` namespaces the series (the sharded cluster facade
        installs each shard's tree as ``s{i}.lsm.*``); gauge and collector
        names are replace-on-reinstall, so a shard reopen rebinds its own
        series without touching its neighbours'."""
        p = prefix
        reg.gauge(f"{p}lsm.debt", lambda: float(self.compaction_debt()))
        reg.gauge(f"{p}lsm.l0_files", lambda: float(len(self.levels[0])))
        reg.gauge(f"{p}lsm.flush_backlog",
                  lambda: float(len(self.immutables) + len(self._flushing)))
        reg.gauge(f"{p}lsm.write_amp", self.write_amplification)
        reg.gauge(f"{p}lsm.delay_rate", lambda: self._delay_rate)
        reg.gauge(f"{p}lsm.write_stalls", lambda: self.stats["write_stalls"])
        reg.gauge(f"{p}lsm.block_cache_hit_rate", self.block_cache.hit_rate)
        reg.gauge(f"{p}lsm.compaction_pace",
                  lambda: float(self.compaction_pace))
        reg.collector(lambda: {
            f"{p}lsm.compaction_rate": self.stats["compactions"],
            f"{p}lsm.flush_rate": self.stats["flushes"],
        }, rate=True, name=f"{p}lsm.rates")
        reg.collector(lambda: {
            f"{p}lsm.debt.by_tenant.{t or 'untagged'}": v
            for t, v in self.debt_by_tenant().items()
        }, rate=False, name=f"{p}lsm.debt.by_tenant")

    # ==================================================================
    # write path
    # ==================================================================
    def put(self, key: int, value: Optional[bytes] = None,
            tombstone: bool = False,
            tenant: Optional[str] = None) -> Generator:
        self.stats["puts"] += 1
        # stall while memtables are full or L0 is overwhelmed
        while (len(self.immutables) >= self.cfg.max_memtables - 1
               and len(self.memtable) >= self.cfg.memtable_max_objs) \
                or len(self.levels[0]) >= self.cfg.l0_stall_files:
            ev = self.sim.event()
            self._stall_waiters.append(ev)
            self.stats["write_stalls"] += 1
            self._kick_background()
            yield ev
        # soft slowdown: pace writes while compactions are behind
        if (len(self.levels[0]) >= self.cfg.l0_slowdown_files
                or self.compaction_debt() > self.cfg.soft_pending_bytes):
            target = max(self.sim.now, self._next_delayed_write) \
                + self.cfg.obj_size / self._delay_rate
            self._next_delayed_write = target
            if target > self.sim.now:
                self.stats["delayed_writes"] += 1
                yield target - self.sim.now   # bare-delay: no Event
        wal_recs = yield from self.backend.wal_append(self.cfg.obj_size)
        stored = value if self.cfg.store_values else None
        mt = self.memtable
        mt.data[key] = (tombstone, stored)
        mt.writes += 1
        if tenant is not None:
            mt.tenant_objs[tenant] = mt.tenant_objs.get(tenant, 0) + 1
        # attribute the WAL bytes (and the logical record, for crash
        # replay) to the generation the data actually landed in (the
        # memtable may have rotated while queued)
        self.backend.wal_attribute(wal_recs, mt.gen, key=key,
                                   tomb=tombstone, value=stored,
                                   tenant=tenant)
        if len(self.memtable) >= self.cfg.memtable_max_objs:
            self._rotate_memtable()

    def delete(self, key: int) -> Generator:
        yield from self.put(key, tombstone=True)

    def _rotate_memtable(self) -> None:
        self.immutables.append(self.memtable)
        self.memtable = MemTable(gen=self.memtable.gen + 1)
        self._kick_background()

    # ==================================================================
    # flush
    # ==================================================================
    def _flush_threshold(self) -> int:
        if self._force_flush or self._wal_pressure:
            return 1
        return self.cfg.min_flush_memtables

    def _on_wal_pressure(self) -> None:
        """WAL zones exhausted: force a memtable switch + flush (RocksDB's
        max_total_wal_size behaviour) so live WAL data dies and zones reset."""
        if len(self.memtable.data):
            self._rotate_memtable()
        self._wal_pressure = True
        self._kick_background()

    def _kick_background(self) -> None:
        if (not self._flush_running
                and len(self.immutables) >= self._flush_threshold()):
            self._flush_running = True
            self.sim.process(self._flush_job())
        self._maybe_compact()

    def flush_all(self) -> Generator:
        """Flush everything (clean-reopen semantics between load and run)."""
        if len(self.memtable.data):
            self._rotate_memtable()
        self._force_flush = True
        self._kick_background()
        while self.immutables or self._flush_running:
            ev = self.sim.event()
            self._flush_watchers.append(ev)
            yield ev
        self._force_flush = False

    def _flush_job(self) -> Generator:
        yield self.jobs.acquire()
        try:
            while len(self.immutables) >= self._flush_threshold():
                batch, self.immutables = self.immutables, []
                # the batch stays readable until its SSTs are installed
                # (RocksDB keeps the immutable memtable alive through the
                # flush; without this, gets in flight miss these keys)
                self._flushing = batch
                gens = {m.gen for m in batch}
                runs, tombs, values = [], [], {}
                for m in reversed(batch):   # newest first
                    ks = np.fromiter(m.data.keys(), dtype=np.uint64,
                                     count=len(m.data))
                    order = np.argsort(ks, kind="stable")
                    ks = ks[order]
                    tb = np.fromiter((m.data[int(k)][0] for k in ks),
                                     dtype=np.bool_, count=len(ks))
                    runs.append(ks)
                    tombs.append(tb)
                    if self.cfg.store_values:
                        for k, (t, v) in m.data.items():
                            values.setdefault(k, v)
                keys, tb = merge_runs(runs, tombs)
                # flush->SST lineage: the batch's per-tenant write-volume
                # shares become each output SST's tenant byte composition
                tally: Dict[str, int] = {}
                writes = 0
                for m in batch:
                    writes += m.writes
                    for t, c in m.tenant_objs.items():
                        tally[t] = tally.get(t, 0) + c
                comp = ({t: c / writes for t, c in tally.items()}
                        if writes > 0 else {})
                for ks, tbs in self._split_sst(keys, tb):
                    sst = self._make_sst(ks, tbs, level=0, values=values)
                    if comp:
                        sst.tenant_bytes = {
                            t: f * sst.size_bytes for t, f in comp.items()}
                    self.backend.on_hint(FlushHint(sst_id=sst.sid))
                    yield from self.backend.write_sst(sst, source="flush")
                    self._install_sst(sst, 0)
                self.backend.wal_flushed(gens)
                self._flushing = []
                self.stats["flushes"] += 1
                self._wake_stalled()
        finally:
            self.jobs.release()
            self._flush_running = False
            self._wal_pressure = False
            watchers, self._flush_watchers = self._flush_watchers, []
            for ev in watchers:
                ev.succeed()
        self._kick_background()

    def _split_sst(self, keys: np.ndarray, tombs: np.ndarray):
        n = self.cfg.sst_max_objs
        for i in range(0, len(keys), n):
            yield keys[i:i + n], tombs[i:i + n]

    def _make_sst(self, keys: np.ndarray, tombs: np.ndarray, level: int,
                  values: Optional[dict] = None) -> SST:
        vals = None
        if self.cfg.store_values and values is not None:
            vals = {int(k): values.get(int(k)) for k in keys}
        sst = SST(sid=self._new_sst_id(), level=level, keys=keys,
                  tombs=tombs, obj_size=self.cfg.obj_size,
                  block_size=self.cfg.block_size, birth=self.sim.now,
                  values=vals)
        if self.cfg.filters == "real":
            filters.attach_filter(sst, self.cfg.filter_bits_per_key)
        return sst

    def _wake_stalled(self) -> None:
        waiters, self._stall_waiters = self._stall_waiters, []
        for ev in waiters:
            ev.succeed()

    # ==================================================================
    # compaction
    # ==================================================================
    def _maybe_compact(self) -> None:
        cfg = self.cfg
        scores = []
        for lvl in range(cfg.num_levels):
            tgt = cfg.target_of(lvl)
            size = self.level_size(lvl)
            if tgt > 0 and size > tgt:
                scores.append((size / tgt, lvl))
        scores.sort(reverse=True)
        for _, lvl in scores:
            if self.jobs.in_use >= self.jobs.capacity:
                break
            inputs = self._pick_compaction(lvl)
            if inputs:
                self.sim.process(self._compaction_job(lvl, inputs))

    def _pick_compaction(self, level: int) -> Optional[List[SST]]:
        """Select input SSTs: Li victim(s) + overlapping Li+1, all unlocked."""
        src = [s for s in self.levels[level] if not s.locked]
        if not src:
            return None
        if level == 0:
            # L0 files overlap freely, so L0 compaction must take ALL of
            # them — if any is locked, a previous L0 compaction is still
            # running and a second one over the leftover files would
            # install L1 outputs overlapping the first one's (breaking the
            # disjointness invariant the read path depends on)
            if any(s.locked for s in self.levels[0]):
                return None
            picked = list(src)
            lo = min(s.min_key for s in picked)
            hi = max(s.max_key for s in picked)
        else:
            cursor = self._rr_key.get(level, -1)
            src_sorted = sorted(src, key=lambda s: s.min_key)
            pick = next((s for s in src_sorted if s.min_key > cursor),
                        src_sorted[0])
            picked = [pick]
            lo, hi = pick.min_key, pick.max_key
            self._rr_key[level] = pick.max_key
        overlap = [s for s in self.levels[level + 1] if s.overlaps(lo, hi)]
        if any(s.locked for s in overlap):
            return None
        inputs = picked + overlap
        for s in inputs:
            s.locked = True
        return inputs

    def _compaction_job(self, level: int, inputs: List[SST]) -> Generator:
        yield self.jobs.acquire()
        cid = self._next_cid = self._next_cid + 1
        cfg = self.cfg
        target = level + 1
        try:
            self.backend.on_hint(CompactionTriggerHint(
                cid=cid, selected_sst_ids=tuple(s.sid for s in inputs),
                target_level=target))
            # read inputs sequentially (interleaved with other jobs);
            # beyond L0 each chunk is paced by the controller's knob —
            # stretching I/O by 1/pace defers debt work under foreground
            # pressure (SILK).  L0 compaction is exempt: clearing L0 is
            # what unblocks stalled foreground writes.
            for s in inputs:
                dev = self.backend.device_of(s.tier)
                rem = s.size_bytes
                while rem > 0:
                    n = min(self.backend.io_chunk, rem)
                    t_io = self.sim.now
                    yield dev.read(n, random=False, tag="compact")
                    pace = self.compaction_pace
                    if level > 0 and pace < 1.0:
                        dt = self.sim.now - t_io
                        if dt > 0:
                            yield dt * (1.0 / max(pace, 0.05) - 1.0)
                    rem -= n
            # merge: newest version wins; inputs ordered newest-priority first
            src_lvl = [s for s in inputs if s.level == level]
            dst_lvl = [s for s in inputs if s.level == target]
            ordered = (sorted(src_lvl, key=lambda s: -s.birth) + dst_lvl
                       if level == 0 else src_lvl + dst_lvl)
            keys, tombs = merge_runs([s.keys for s in ordered],
                                     [s.tombs for s in ordered])
            values = None
            if cfg.store_values:
                values = {}
                for s in ordered:
                    if s.values:
                        for k, v in s.values.items():
                            values.setdefault(k, v)
            # drop tombstones when compacting into the last populated level
            bottom = all(not self.levels[l] for l in
                         range(target + 1, len(self.levels)))
            if bottom and len(keys):
                keep = ~tombs
                keys, tombs = keys[keep], tombs[keep]
            # compaction lineage: outputs inherit the inputs' pooled
            # tenant byte composition, scaled to each output's size
            in_attr: Dict[str, float] = {}
            in_bytes = 0
            for s in inputs:
                in_bytes += s.size_bytes
                for t, b in getattr(s, "tenant_bytes", {}).items():
                    in_attr[t] = in_attr.get(t, 0.0) + b
            comp = ({t: b / in_bytes for t, b in in_attr.items()}
                    if in_bytes > 0 else {})
            outputs: List[SST] = []
            for ks, tbs in self._split_sst(keys, tombs):
                if not len(ks):
                    continue
                sst = self._make_sst(ks, tbs, level=target, values=values)
                if comp:
                    sst.tenant_bytes = {
                        t: f * sst.size_bytes for t, f in comp.items()}
                self.backend.on_hint(CompactionOutputHint(
                    cid=cid, sst_id=sst.sid, level=target))
                t_io = self.sim.now
                yield from self.backend.write_sst(sst, source="compaction")
                pace = self.compaction_pace
                if level > 0 and pace < 1.0:
                    dt = self.sim.now - t_io
                    if dt > 0:
                        yield dt * (1.0 / max(pace, 0.05) - 1.0)
                outputs.append(sst)
            # install outputs, delete inputs
            for s in inputs:
                self._remove_sst(s)
                self.block_cache.drop_sst(s.sid)
                self.backend.delete_sst(s)
            for s in outputs:
                self._install_sst(s, target)
            self.levels[target].sort(key=lambda s: s.min_key)
            self.backend.on_hint(CompactionDoneHint(
                cid=cid, target_level=target, num_selected=len(inputs),
                num_generated=len(outputs),
                input_sst_ids=tuple(s.sid for s in inputs),
                output_sst_ids=tuple(s.sid for s in outputs)))
            self.stats["compactions"] += 1
        finally:
            for s in inputs:
                s.locked = False
            self.jobs.release()
            self._wake_stalled()
        self._kick_background()

    # ==================================================================
    # read path
    # ==================================================================
    def _memtable_lookup(self, key: int):
        """Newest-first memtable-tier lookup -> (found, value) or None."""
        for m in [self.memtable] + list(reversed(self.immutables)) \
                + list(reversed(self._flushing)):
            if key in m.data:
                tomb, val = m.data[key]
                if not tomb:
                    self.stats["hits"] += 1
                return (not tomb, val)
        return None

    def _level_index(self, lvl: int):
        """Read index for one level, rebuilt only when the level's
        membership epoch moves (SST install/remove): candidate SSTs in
        lookup order, their key ranges as plain ints / a sorted uint64
        array for bisection, whether its filtered SSTs mix ``filter_k``
        values (see get_batch), and the level's concatenated
        filter image — under ``filter_impl="torch"`` an int32 tensor
        uploaded to ``torch_device`` here, once per epoch.

        L0 files overlap, so they are ordered newest-first by ``birth`` —
        the list's install order is NOT trustworthy (after ``DB.reopen()``
        the manifest rebuild installs by sid, and migrations can reorder
        too); trusting it returned stale versions.  Deeper levels are
        disjoint, so each key has at most one candidate, found by
        bisecting the sorted min-key array."""
        cached = self._ridx.get(lvl)
        if cached is not None and cached[0] == self._level_epoch[lvl]:
            return cached[1]
        if lvl == 0:
            ssts = sorted(self.levels[0], key=lambda s: -s.birth)
            mins: List[int] = []
            mins_np = None
        else:
            ssts = sorted(self.levels[lvl], key=lambda s: s.min_key)
            mins = [s.min_key for s in ssts]
            mins_np = np.array(mins, dtype=np.uint64)
        maxs = [s.max_key for s in ssts]
        mixed_k = len({s.filter_k for s in ssts
                       if s.filter_words is not None}) > 1
        bits, offsets = (filters.concat_filters(ssts)
                         if self.cfg.filters == "real" else (None, None))
        if bits is not None and self.cfg.filter_impl == "torch":
            bits = filters.device_words(bits, self.torch_device)
        idx = (ssts, mins, mins_np, maxs, mixed_k, bits, offsets)
        self._ridx[lvl] = (self._level_epoch[lvl], idx)
        return idx

    def _level_candidates(self, lvl: int, key: int) -> List[SST]:
        """SSTs of level ``lvl`` whose range covers ``key``, in lookup
        order (see _level_index for the ordering contract)."""
        ssts, mins, _, maxs = self._level_index(lvl)[:4]
        if lvl == 0:
            return [s for s in ssts if s.min_key <= key <= s.max_key]
        j = bisect_right(mins, key) - 1
        if j >= 0 and key <= maxs[j]:
            return [ssts[j]]
        return []

    def _level_pairs(self, lvl: int, keys: List[int],
                     pending: List[int]) -> List[List[SST]]:
        """Candidate SSTs of level ``lvl`` for each pending key, in lookup
        order; deeper levels are disjoint, so one searchsorted over the
        whole batch replaces per-key range scans."""
        ssts, _, mins_np, maxs = self._level_index(lvl)[:4]
        if lvl == 0:
            return [[s for s in ssts if s.min_key <= keys[i] <= s.max_key]
                    for i in pending]
        karr = np.fromiter((keys[i] for i in pending), np.uint64,
                           len(pending))
        pos = np.searchsorted(mins_np, karr, side="right") - 1
        return [[ssts[j]] if j >= 0 and keys[i] <= maxs[j] else []
                for i, j in zip(pending, pos.tolist())]

    def _store_image(self) -> filters.StoreImage:
        """Every level's filters in one :class:`filters.StoreImage` with a
        slot per filtered SST: on the torch route the levels' resident
        images from ``_level_index`` joined on their device (no upload),
        the slot table uploaded beside them.  Rebuilt only when some
        level's membership epoch moves."""
        epochs = tuple(self._level_epoch[:len(self.levels)])
        if self._simg is not None and self._simg[0] == epochs:
            return self._simg[1]
        chunks, entries, base = [], [], 0
        for lvl, level in enumerate(self.levels):
            if not level:
                continue
            ssts, *_, bits, offsets = self._level_index(lvl)
            entries += [(s.sid, base + offsets[s.sid][0],
                         offsets[s.sid][1], s.filter_k)
                        for s in ssts if s.sid in offsets]
            chunks.append(bits)
            base += bits.shape[0]
        image = filters.StoreImage(
            chunks, entries,
            self.torch_device if self.cfg.filter_impl == "torch" else None)
        self._simg = (epochs, image)
        return image

    def _probe_slots(self, keys: np.ndarray, pair_key: np.ndarray,
                     pair_ssts: List[SST],
                     k: Optional[int] = None) -> np.ndarray:
        """One probe call against the store image: pair ``p`` is
        ``keys[pair_key[p]]`` (``keys`` uint64, ``pair_key`` int32) against
        ``pair_ssts[p]``, with the SST's own ``filter_k``, or with ``k``
        for every pair when given.  Filterless SSTs (built under another
        mode) pass without a probe; no call is made when every pair's SST
        is filterless."""
        image = self._store_image()
        slot = image.slots_of(pair_ssts)
        sel = slot >= 0
        full = bool(sel.all())
        if not full:
            if not sel.any():
                return np.ones(len(pair_ssts), dtype=bool)
            pair_key, slot = pair_key[sel], slot[sel]
        pair_k = (image.slot_k[slot] if k is None
                  else np.full(len(slot), k, dtype=np.uint8))
        got = self._prober.probe_pairs(image, keys, pair_key, slot, pair_k)
        if full:
            return got
        hits = np.ones(len(pair_ssts), dtype=bool)
        hits[sel] = got
        return hits

    def _probe_key(self, key: int, ssts: List[SST]) -> Dict[int, bool]:
        """Real-filter hits {sid: hit} of one key against filtered SSTs on
        the torch route, in one call against the store image, each SST
        probed with its own ``filter_k``."""
        if not ssts:
            return {}
        got = self._probe_slots(np.array([key], dtype=np.uint64),
                                np.zeros(len(ssts), dtype=np.int32), ssts)
        return dict(zip((s.sid for s in ssts), got.tolist()))

    def _key_hits(self, key: int) -> Dict[int, bool]:
        """The per-key read's filter hits on the torch route: the key's
        candidates on every level probed in one call before the walk.  A
        probe's answer depends only on (key, SST), so probing SSTs the walk
        may not reach changes no result; ``_filter_hit`` probes any SST
        installed after this call when the walk meets it.  Empty on the
        other routes, which probe each candidate as the walk meets it."""
        if self.cfg.filters != "real" or self.cfg.filter_impl != "torch":
            return {}
        return self._probe_key(key, [
            s for lvl in range(len(self.levels))
            for s in self._level_candidates(lvl, key)
            if s.filter_words is not None])

    def _filter_hit(self, sst: SST, key: int, hits: Dict[int, bool]) -> bool:
        """One Bloom probe under the configured filter mode; on the torch
        route the answer comes from the read's ``_key_hits``."""
        self.stats["filter_probes"] += 1
        if self.cfg.filters == "injected":
            return sst.bloom_maybe_contains(key, self.cfg.bloom_fp_rate)
        if sst.filter_words is None:       # filterless SST: must check
            return True
        if self.cfg.filter_impl == "numpy":
            return filters.probe_one_np(key, sst.filter_words, sst.filter_k)
        if sst.sid not in hits:            # installed during this read
            hits.update(self._probe_key(key, [sst]))
        return hits[sst.sid]

    def _probe_sst(self, sst: SST, key: int) -> Generator:
        """Exact lookup in one surviving candidate: block I/O (cache hit
        or device read), logical-read accounting, tombstone check.
        Returns (found, value|None) or None when the key is absent (a
        Bloom false positive)."""
        found, idx = sst.find(key)
        blk = sst.block_of(idx if found else
                           min(idx, max(sst.num_objs - 1, 0)))
        # logical read: the §3.4 popularity signal counts cache hits too —
        # a fully cache-resident hot SST must not look cold to the migrator
        sst.num_reads += 1
        if not self.block_cache.get(sst.sid, blk):
            yield from self.backend.read_block(sst, blk)
            self.block_cache.insert(sst.sid, blk)
        if found:
            if bool(sst.tombs[idx]):
                return (False, None)
            self.stats["hits"] += 1
            val = sst.values.get(key) if sst.values else None
            return (True, val)
        self.stats["bloom_fp"] += 1
        return None

    def get(self, key: int) -> Generator:
        """Generator returning (found, value|None)."""
        self.stats["gets"] += 1
        mem = self._memtable_lookup(key)
        if mem is not None:
            return mem
        hits = self._key_hits(key)
        for lvl in range(len(self.levels)):
            for sst in self._level_candidates(lvl, key):
                if not self._filter_hit(sst, key, hits):
                    continue
                res = yield from self._probe_sst(sst, key)
                if res is not None:
                    return res
        return (False, None)

    def get_batch(self, keys: List[int]) -> Generator:
        """Service a batch of point reads; returns [(found, value|None)].

        Result-identical to per-key :meth:`get` (asserted across every
        scheme by ``tests/test_differential.py``): the same newest-first
        lookup order, the same block I/O per surviving candidate.  The
        difference is *how* candidates are found and probed: under real
        filters the (key x candidate-SST) pairs of every level are probed
        before the walk in one call (``_batch_hits``: the
        ``bloom_probe_pairs`` kernel on a CUDA ``torch_device``, its plain
        version on the CPU, or numpy, per ``LSMConfig.filter_impl``), and
        the walk goes level by level through the precomputed hits, counting
        in ``stats["filter_probes"]`` only the pairs of keys still pending
        there, as the reference's per-level calls do.  A level is probed
        again at walk time, with the reference's per-level call
        (``_probe_pairs_real``), when its membership epoch moved since the
        batch's call (a flush or compaction ran while the walk waited on
        I/O) or when its filtered SSTs do not share one ``filter_k`` (the
        reference probes a level's pending pairs with their largest k);
        ``probe_calls`` counts both.  Only survivors reach the block
        cache / backend."""
        n = len(keys)
        self.stats["gets"] += n
        results: List[Optional[Tuple[bool, Optional[bytes]]]] = [None] * n
        pending: List[int] = []
        for i, key in enumerate(keys):
            mem = self._memtable_lookup(key)
            if mem is not None:
                results[i] = mem
            else:
                pending.append(i)
        real = self.cfg.filters == "real"
        plan, batch_hits = (self._batch_hits(keys, pending)
                            if real and pending else ({}, None))
        for lvl in range(len(self.levels)):
            if not pending:
                break
            if not self.levels[lvl]:
                continue
            got = plan.get(lvl)
            if got is not None and got[0] == self._level_epoch[lvl]:
                cands, first = got[1], got[2]
                pair_of = [cands[i] for i in pending]
                at = [first[i] for i in pending]
                hits = batch_hits
            else:
                pair_of = self._level_pairs(lvl, keys, pending)
                flat = [(i, sst) for i, c in zip(pending, pair_of)
                        for sst in c]
                if not flat:
                    continue
                at = list(accumulate((len(c) for c in pair_of[:-1]),
                                     initial=0))
                if real:
                    mixed_k = self._level_index(lvl)[4]
                    self.probe_calls["reprobe_mixed_k" if mixed_k
                                     else "reprobe_epoch"] += 1
                    hits = self._probe_pairs_real(
                        np.array([keys[i] for i, _ in flat],
                                 dtype=np.uint64), [s for _, s in flat])
                else:
                    hits = [sst.bloom_maybe_contains(keys[i],
                                                     self.cfg.bloom_fp_rate)
                            for i, sst in flat]
            n_pairs = sum(len(c) for c in pair_of)
            if not n_pairs:
                continue
            # walk survivors per key in candidate order, stopping at the
            # first exact hit — byte-identical I/O to the per-key path
            self.stats["filter_probes"] += n_pairs
            still: List[int] = []
            for i, cands_i, a in zip(pending, pair_of, at):
                key = keys[i]
                for j, sst in enumerate(cands_i):
                    if results[i] is not None or not hits[a + j]:
                        continue
                    res = yield from self._probe_sst(sst, key)
                    if res is not None:
                        results[i] = res
                if results[i] is None:
                    still.append(i)
            pending = still
        for i in pending:
            results[i] = (False, None)
        return results

    def _batch_hits(self, keys: List[int], pending: List[int]):
        """The batched read's one probe call: the candidates of every
        pending key on every level whose filtered SSTs share one
        ``filter_k``, probed against the store image with each pair's
        level k, keys sent once each.  Returns ({lvl: (epoch, cands,
        first)}, hits), where ``cands[i]`` are key ``i``'s candidates on
        the level and ``first[i]`` the index of its first pair in
        ``hits``."""
        plan: Dict[int, Tuple] = {}
        pair_key: List[int] = []
        pair_ssts: List[SST] = []
        n = len(keys)
        for lvl, level in enumerate(self.levels):
            if not level or self._level_index(lvl)[4]:    # mixed filter_k
                continue
            cands: List = [()] * n
            first = [0] * n
            for t, (i, c) in enumerate(zip(pending, self._level_pairs(
                    lvl, keys, pending))):
                if c:
                    cands[i], first[i] = c, len(pair_ssts)
                    pair_key += [t] * len(c)
                    pair_ssts += c
            plan[lvl] = (self._level_epoch[lvl], cands, first)
        if not pair_ssts:
            return plan, None
        hits = self._probe_slots(
            np.fromiter((keys[i] for i in pending), np.uint64, len(pending)),
            np.array(pair_key, dtype=np.int32), pair_ssts)
        self.probe_calls["batch"] += 1
        return plan, hits

    def _probe_pairs_real(self, pair_keys: np.ndarray,
                          pair_ssts: List[SST]) -> np.ndarray:
        """The reference's per-level call, against the store image: every
        pair probed with ``k = max(filter_k)`` of the pairs' filtered
        SSTs, as in the reference.  Pairs that all name one SST probe its
        filter alone (the single-filter kernel, keys hashed on the host);
        others take the pairs kernel."""
        image = self._store_image()
        slot = image.slots_of(pair_ssts)
        sel = slot >= 0
        if not sel.any():
            return np.ones(len(pair_ssts), dtype=bool)
        k = int(image.slot_k[slot[sel]].max())
        if (slot[sel] == slot[sel][0]).all():
            hits = np.ones(len(pair_ssts), dtype=bool)
            lo, hi = filters.split_hash(pair_keys[sel])
            hits[sel] = self._prober.probe(image, int(slot[sel][0]), lo, hi,
                                           k)
            return hits
        return self._probe_slots(pair_keys,
                                 np.arange(len(pair_keys), dtype=np.int32),
                                 pair_ssts, k)

    def scan(self, start_key: int, count: int) -> Generator:
        """Range scan over [start, start+count): reads the covering blocks
        per level and returns the number of *live* keys in the range.

        Versions are deduplicated newest-first (memtables, then L0 by
        birth, then deeper levels) and tombstoned keys are skipped, so the
        count is exact — identical across schemes and equal to a dict
        model's, independent of compaction timing.  I/O is still charged
        for every overlapping SST (shadowed versions must be read to be
        discarded, as in a real merging iterator)."""
        self.stats["scans"] += 1
        end_key = start_key + count
        newest: Dict[int, bool] = {}   # key -> newest version is a tombstone
        for m in [self.memtable] + list(reversed(self.immutables)) \
                + list(reversed(self._flushing)):
            for k, (tomb, _) in m.data.items():
                if start_key <= k < end_key:
                    newest.setdefault(k, tomb)
        for lvl in range(len(self.levels)):
            ssts = (sorted(self.levels[0], key=lambda s: -s.birth)
                    if lvl == 0 else self.levels[lvl])
            for sst in ssts:
                if not sst.overlaps(start_key, end_key - 1):
                    continue
                cnt = sst.count_in_range(start_key, end_key)
                if cnt <= 0:
                    continue
                nblocks = -(-cnt // sst.objs_per_block)
                a = int(np.searchsorted(sst.keys, np.uint64(start_key)))
                for b in range(nblocks):
                    blk = sst.block_of(min(a + b * sst.objs_per_block,
                                           sst.num_objs - 1))
                    sst.num_reads += 1   # logical read, cache hit or miss
                    if not self.block_cache.get(sst.sid, blk):
                        yield from self.backend.read_block(sst, blk)
                        self.block_cache.insert(sst.sid, blk)
                for i in range(a, a + cnt):
                    newest.setdefault(int(sst.keys[i]), bool(sst.tombs[i]))
        return sum(1 for tomb in newest.values() if not tomb)
