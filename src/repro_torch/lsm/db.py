"""KV store facade: sim + devices + middleware + LSM-tree, per scheme.

Scheme names follow the paper:
  B1..B4    basic placement (§2.3), level threshold h
  B3+M      basic + workload-aware migration (Exp#2)
  AUTO      SpanDB automated placement (§4.1)
  P         HHZS write-guided placement only
  P+M       + workload-aware migration
  P+M+C     + application-hinted caching  (== HHZS, the full system)
  HHZS      alias of P+M+C

Scaling: the paper's setup is reproduced at 1/SCALE.  Every *size* (object
dataset, SSTs, zones, MemTables, level targets, caches) and every
*bandwidth* (sequential device rates, migration rate limit, delayed-write
rate) is divided by SCALE, while random-read IOPS and per-request overheads
are kept — this preserves all the paper's time ratios exactly (an SST
migration still takes ~4.2 virtual minutes at the default rate; loading
still takes ~8 virtual hours), with 1/SCALE the number of simulated
operations.  Reported OPS are therefore paper-OPS / SCALE.

Bloom filter images and probes live on ``DB(torch_device=...)``: the CUDA
card by default, the CPU only when the caller asks for it.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from ..core.middleware import (AdmissionConfig, AdmissionController,
                               HybridZonedBackend)
from ..core.placement import (AutoPlacement, BasicScheme, HHZSPlacement,
                              PlacementPolicy)
from ..zoned.device import (MiB, ST14000_HDD, ZN540_SSD, DeviceTiming,
                            ZonedDevice)
from ..zoned.sim import Sim
from .tree import LSMConfig, LSMTree, MemTable

SCALE = 100  # paper sizes & bandwidths / SCALE


def _scaled_timing(t: DeviceTiming, s: int) -> DeviceTiming:
    """Scale every *rate* by 1/s (sizes are scaled elsewhere): the simulated
    system is then exactly the paper's system slowed down by s — every
    dimensionless ratio (cache lifetime / run length, migration time / SST
    churn, interference fractions) is preserved.  Virtual durations match
    the paper 1:1; simulated OPS = paper OPS / s; latencies = paper × s."""
    return DeviceTiming(seq_read_bw=t.seq_read_bw / s,
                        seq_write_bw=t.seq_write_bw / s,
                        rand_read_iops=t.rand_read_iops / s,
                        seq_overhead=t.seq_overhead)


@dataclass
class ScenarioConfig:
    ssd_zones: int = 20
    ssd_zone_cap: int = int(1077 * MiB) // SCALE
    hdd_zones: int = 12000
    hdd_zone_cap: int = int(256 * MiB) // SCALE
    wal_cache_zones: int = 2
    migration_rate: float = 4 * MiB / SCALE
    io_chunk: int = max(4096, int(1 * MiB) // SCALE)
    ssd_timing: DeviceTiming = _scaled_timing(ZN540_SSD, SCALE)
    hdd_timing: DeviceTiming = _scaled_timing(ST14000_HDD, SCALE)
    lsm: LSMConfig = field(default_factory=lambda: LSMConfig(
        sst_size=int(1011.2 * MiB) // SCALE,
        memtable_size=int(512 * MiB) // SCALE,
        level_targets=(int(1024 * MiB) // SCALE, int(1024 * MiB) // SCALE,
                       int(10 * 1024 * MiB) // SCALE,
                       int(100 * 1024 * MiB) // SCALE,
                       int(1000 * 1024 * MiB) // SCALE),
        block_cache_blocks=int(8 * MiB) // SCALE // 4096,
        soft_pending_bytes=int(64 * 1024 * MiB) // SCALE,
        delayed_write_rate=16 * MiB / SCALE,
    ))

    @property
    def paper_keys(self) -> int:
        """200 GiB of 1 KiB objects, scaled."""
        return int(200 * 1024 * MiB / SCALE / self.lsm.obj_size)


SCHEMES = ("B1", "B2", "B3", "B4", "B3+M", "AUTO", "P", "P+M", "P+M+C", "HHZS")


def _build_placement(scheme: str) -> PlacementPolicy:
    if scheme.startswith("B"):
        h = int(scheme[1])
        return BasicScheme(h)
    if scheme == "AUTO":
        return AutoPlacement()
    return HHZSPlacement()


class DB:
    """One KV store instance on one hybrid zoned storage scenario."""

    def __init__(self, scheme: str = "HHZS",
                 scenario: Optional[ScenarioConfig] = None,
                 store_values: bool = False,
                 admission: "AdmissionConfig | str" = "none",
                 telemetry: "bool | float" = False,
                 sim: Optional[Sim] = None,
                 torch_device: str = "cuda"):
        base = scheme.split("+")[0]
        if scheme not in SCHEMES:
            raise ValueError(f"unknown scheme {scheme!r}; one of {SCHEMES}")
        self.scheme = scheme
        sc = scenario or ScenarioConfig()
        if store_values:
            sc = replace(sc, lsm=replace(sc.lsm, store_values=True))
        self.scenario = sc
        # ``sim`` lets several stores share one DES clock — the sharded
        # cluster facade (repro_torch.cluster) runs N shard DBs on one
        # simulator
        self.sim = sim if sim is not None else Sim()
        self.ssd = ZonedDevice(self.sim, "ssd", sc.ssd_timing,
                               sc.ssd_zones, sc.ssd_zone_cap)
        self.hdd = ZonedDevice(self.sim, "hdd", sc.hdd_timing,
                               sc.hdd_zones, sc.hdd_zone_cap)
        placement = _build_placement(base)
        enable_m = scheme in ("B3+M", "P+M", "P+M+C", "HHZS")
        enable_c = scheme in ("P+M+C", "HHZS")
        self.backend = HybridZonedBackend(
            self.sim, self.ssd, self.hdd, placement,
            wal_cache_zones=sc.wal_cache_zones,
            block_size=sc.lsm.block_size,
            enable_migration=enable_m,
            enable_cache=enable_c,
            migration_rate=sc.migration_rate,
            io_chunk=sc.io_chunk,
            basic_migration_low_levels=(3 if scheme == "B3+M" else None),
        )
        self.torch_device = torch_device
        self.tree = LSMTree(self.sim, sc.lsm, self.backend, torch_device)
        # multi-tenant admission control (policy "none" admits everything);
        # consulted by submit(..., tenant=...) and the open-loop runners
        self.admission = AdmissionController(self.sim, self.backend,
                                             admission)
        # compaction debt is the third admission pressure signal (consulted
        # only when the policy sets a debt_threshold); the lambda reads
        # through self.tree so it survives crash/reopen tree swaps
        self.admission.debt_gauge = lambda: float(self.tree.compaction_debt())
        self._crashed = False
        self.recovery: Optional[dict] = None   # stats of the last reopen()
        # telemetry bus (repro_torch.obs): off by default; telemetry=True
        # attaches a MetricsRegistry at the default sample period, a float
        # sets the period in virtual seconds
        self.metrics = None
        if telemetry:
            self.enable_telemetry(
                5.0 if telemetry is True else float(telemetry))
        self.backend.start()

    # ---- telemetry (repro_torch.obs) ----------------------------------
    def enable_telemetry(self, sample_period: float = 5.0,
                         capacity: int = 720):
        """Attach a ``MetricsRegistry`` sampling every layer's signals on
        the DES clock; idempotent.  Returns the registry.

        All built-in signals are pull gauges over state the layers already
        maintain, so enabling telemetry never changes the virtual-time
        history of a run."""
        if self.metrics is not None:
            return self.metrics
        from ..obs import MetricsRegistry
        reg = MetricsRegistry(self.sim, sample_period, capacity)
        self.ssd.install_metrics(reg, "ssd")
        self.hdd.install_metrics(reg, "hdd")
        self.backend.install_metrics(reg)
        self.tree.install_metrics(reg)
        self.admission.install_metrics(reg)
        reg.start()
        self.metrics = reg
        return reg

    # ---- store interface (repro_torch.workloads.* target this) --------
    # The open-loop runners, OpStream and the scenario matrix talk to any
    # object exposing: sim/now, kv (op generators: put/get/get_batch/
    # delete/scan), submit, run_for, drain, flush_all, extras(),
    # compaction_debt(), fresh_admission(), scheme/scenario.  DB and
    # repro_torch.cluster.ShardedDB both satisfy it.
    @property
    def kv(self):
        """Op-generator surface (put/get/get_batch/delete/scan).  For a
        single store this is the LSM tree itself; the sharded facade
        returns its routing layer instead."""
        return self.tree

    def compaction_debt(self) -> float:
        """Bytes of compaction backlog (admission's third pressure signal).
        Reads through ``self.tree`` so it survives crash/reopen swaps."""
        return float(self.tree.compaction_debt())

    def extras(self) -> dict:
        """Device/cache/migration counters attached to every result row."""
        tree = self.tree
        extras = {
            "ssd_read_bytes": self.ssd.counters.read_bytes,
            "hdd_read_bytes": self.hdd.counters.read_bytes,
            "ssd_write_bytes": self.ssd.counters.write_bytes,
            "hdd_write_bytes": self.hdd.counters.write_bytes,
            "block_cache_hit_rate": tree.block_cache.hit_rate(),
            # Bloom accounting: probes of candidate SSTs and survivors that
            # turned out absent; fp-per-probe = bloom_fp / filter_probes
            "filter_probes": tree.stats["filter_probes"],
            "bloom_fp": tree.stats["bloom_fp"],
        }
        if self.backend.cache is not None:
            extras["ssd_cache_hits"] = self.backend.cache.hits
            extras["ssd_cache_admitted"] = self.backend.cache.admitted
        if self.backend.migrator is not None:
            extras["migrated_bytes"] = self.backend.migrator.bytes_moved
        return extras

    def fresh_admission(self, policy=None) -> AdmissionController:
        """Install and return a fresh per-run admission controller.

        Counters, the per-run protected-set widening and the queue gauge
        must not leak between runs on the same store; ``policy`` (a name
        or ``AdmissionConfig``) overrides the constructor's config for
        this run only — the pristine ``base_cfg`` is preserved so a later
        ``policy=None`` run still sees the constructor's policy."""
        orig_base = self.admission.base_cfg
        self.admission = AdmissionController(
            self.sim, self.backend,
            policy if policy is not None else orig_base)
        self.admission.base_cfg = orig_base
        self.admission.debt_gauge = lambda: float(self.compaction_debt())
        if self.metrics is not None:
            self.admission.install_metrics(self.metrics)
        return self.admission

    # ---- synchronous helpers (tests / examples) -----------------------
    def _run(self, gen):
        return self.sim.run_until(self.sim.process(gen))

    def put(self, key: int, value: Optional[bytes] = None):
        return self._run(self.tree.put(key, value))

    def get(self, key: int):
        return self._run(self.tree.get(key))

    def get_batch(self, keys):
        """Service concurrently-arriving point reads in one batched call
        (vectorized Bloom probing; see ``LSMTree.get_batch``)."""
        return self._run(self.tree.get_batch(list(keys)))

    def delete(self, key: int):
        return self._run(self.tree.delete(key))

    def scan(self, start_key: int, count: int):
        return self._run(self.tree.scan(start_key, count))

    def flush_all(self):
        """Flush all MemTables + WAL (clean reopen between load and run)."""
        return self._run(self.tree.flush_all())

    def drain(self) -> None:
        """Run the simulator until all background work settles."""
        self.sim.run()

    # ---- crash / recovery ---------------------------------------------
    def crash(self) -> None:
        """Power loss at the current virtual instant.

        Everything volatile dies: the MemTables (active, immutable and
        flushing), every in-flight op and background job (the whole event
        heap), the device service queues and the WAL group-commit queue.
        Durable state survives: zones and their write pointers, installed
        SSTs (the manifest), and live WAL records with their logical
        payloads.  Call :meth:`reopen` to recover; until then the store
        must not be used.
        """
        sim = self.sim
        # pin everything we are about to kill: dropping the last reference
        # to a suspended generator raises GeneratorExit inside it, running
        # its `finally` blocks (semaphore releases, waiter wake-ups) and
        # thereby resurrecting other dead processes — but a power loss
        # must not execute ANY further code.  The graveyard keeps the dead
        # suspended forever instead.
        g = sim.graveyard
        g.append(list(sim._heap))
        g.append(self.backend._wal_waiters)
        g.append(self.backend._wal_queue)
        g.append(self.tree._stall_waiters)
        g.append(self.tree._flush_watchers)
        g.append(self.tree.jobs._queue)
        g.append(self.tree)
        # every pending event — in-flight ops, flush/compaction/migration
        # jobs, daemon pollers — dies with the process, including the
        # batched per-device completion queues (their heads are heap
        # entries and die with the heap clear below)
        for q in sim._mono:
            g.append(q.crash_clear())
        sim._heap.clear()
        sim._live = 0
        for dev in (self.ssd, self.hdd):
            dev.restart()
        self.backend.crash_volatile()
        self._crashed = True

    def reopen_gen(self):
        """Generator: recovery in virtual time (replay I/O is charged).

        Mirrors RocksDB recovery on zoned storage: rebuild the SST registry
        and level counts from the manifest, reset every zone not referenced
        by durable state (partial SST writes, compaction outputs, migration
        destinations, cache fills), then read the live WAL zones and replay
        their logical records into fresh MemTables, oldest generation
        first.  Returns (and stores in ``self.recovery``) replay stats.
        """
        if not self._crashed:
            raise RuntimeError("reopen() requires a preceding crash()")
        be, sim = self.backend, self.sim
        old = self.tree
        ssts = sorted(old.manifest.values(), key=lambda s: s.sid)
        be.reopen_rebuild(ssts)
        # fresh LSM tree over the recovered registry (rebinds the WAL
        # pressure callback and starts a new delayed-write controller)
        tree = LSMTree(sim, self.scenario.lsm, be, self.torch_device)
        tree._next_sst = max([old._next_sst] + [s.sid for s in ssts])
        for sst in ssts:
            tree._install_sst(sst, sst.level)
        for lvl in range(1, len(tree.levels)):
            tree.levels[lvl].sort(key=lambda s: s.min_key)
        # WAL replay: read every live WAL zone (recovery I/O is real I/O),
        # then rebuild the MemTables from the per-generation payloads —
        # ascending generations reproduce the original insert order, so
        # newest-version-wins semantics are preserved exactly
        for rec in be._wal_records:
            if rec["zone"].write_ptr > 0:
                yield rec["dev"].read(rec["zone"].write_ptr, random=False,
                                      tag="recover")
        gens = sorted({g for rec in be._wal_records for g in rec["gens"]})
        replayed = 0
        for g in gens:
            mt = MemTable(gen=g)
            for key, tomb, value, tenant in be._wal_payloads.get(g, ()):
                mt.data[key] = (tomb, value)
                # re-attribute the record so per-tenant debt attribution
                # (MemTable.tenant_objs -> SST lineage) survives the crash
                mt.writes += 1
                if tenant is not None:
                    mt.tenant_objs[tenant] = \
                        mt.tenant_objs.get(tenant, 0) + 1
                replayed += 1
            tree.immutables.append(mt)
        # the new active generation must exceed every generation ever used,
        # or a later flush could reclaim the new generation's WAL records
        tree.memtable = MemTable(gen=old.memtable.gen + 1)
        self.tree = tree
        # the SLO control plane's rate overrides are volatile controller
        # state, but they live on the (surviving) AdmissionController —
        # without this reset a restarted-from-scratch ControlPlane would
        # inherit the pre-crash throttle levels (regression-tested by
        # tests/test_control_v2.py)
        self.admission.rate_overrides.clear()
        # restart background machinery (placement monitor, migrator loop)
        be.start()
        tree._kick_background()
        if self.metrics is not None:
            # the sampler process died with the crash; gauges over the old
            # tree are rebound to the recovered one, then sampling resumes
            tree.install_metrics(self.metrics)
            self.metrics.restart()
        self._crashed = False
        self.recovery = {"at": sim.now,
                         "live_wal_zones": len(be._wal_records),
                         "replayed_gens": len(gens),
                         "replayed_records": replayed}
        return self.recovery

    def reopen(self) -> dict:
        """Synchronous crash recovery (see :meth:`reopen_gen`)."""
        return self._run(self.reopen_gen())

    # ---- open-loop facade (repro_torch.workloads.runner) --------------
    @property
    def now(self) -> float:
        """Current virtual time, seconds."""
        return self.sim.now

    def submit(self, gen, tenant: Optional[str] = None):
        """Schedule an op generator without blocking (open-loop dispatch).

        Returns the Process, itself an Event that fires on completion —
        callers track in-flight ops instead of waiting synchronously.

        With ``tenant`` the op goes through the admission-control layer
        (``self.admission``): under policies ``reject``/``token_bucket`` the
        op may be shed, in which case the generator is closed unexecuted
        and ``None`` is returned; under ``delay`` it is held until store
        pressure clears before running.
        """
        if tenant is not None:
            return self.admission.submit(gen, tenant)
        return self.sim.process(gen)

    def run_for(self, seconds: float) -> None:
        """Advance virtual time by ``seconds`` (time-limited open-loop runs)."""
        self.sim.run(until=self.sim.now + seconds)
