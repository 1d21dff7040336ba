"""Sharded store facade: N shard ``DB``-s on one DES clock.

``ShardedDB`` satisfies the same store interface as ``repro_torch.lsm.DB``
(``sim/now/kv/submit/run_for/drain/flush_all/extras/compaction_debt/
fresh_admission/crash/reopen_gen/scheme/scenario``), so every workload
runner and the scenario matrix drive it unchanged.  Three middleware
mechanisms live here:

* :class:`RouterKV` — the op-generator surface.  Point ops resolve their
  owning shard through the pluggable router (``repro_torch.cluster.router``)
  and delegate to that shard's LSM tree via ``yield from`` (zero extra
  DES events — a 1-shard cluster is event-for-event identical to a bare
  ``DB``, asserted by ``tests/test_torch_cluster.py``).  Ops aimed at a down
  shard or at a range mid-split *park* on an Event and retry when the
  cluster state changes; per-shard routed/completed counters and
  in-flight spans feed availability accounting and the split drain.
* **Online split** (:meth:`ShardedDB.split`) — a middleware operation
  charged in virtual time: drain in-flight ops overlapping the moving
  range (new ones park), enumerate the range's live keys, copy them with
  charged reads on the source and charged writes (WAL + flush pipeline)
  on the target, tombstone stale target copies left by an earlier
  aborted/backward split, then atomically flip the routing map and
  release the parked ops.  A crash of either endpoint mid-split bumps
  the split epoch: the surviving split process observes the bump after
  its next yield and aborts; routing never half-flips.
* **Rebalancer** — a daemon reading the per-shard op-rate series from
  the metrics bus; when the hottest shard's rate exceeds
  ``rebalance_factor ×`` the mean it splits that shard's most populous
  segment at the head-biased sqrt quantile (the mass median of a
  zipf-style hot spot anchored at the segment head) and hands the
  sqrt(W)-key head — half the traffic, a cheap copy — to the coldest
  shard via ``split()``.

Per-shard crash (``crash_shard``/``reopen_shard_gen``) is implemented by
``repro_torch.cluster.crash``: the crashed shard's processes and queue entries
are surgically removed from the shared kernel while every other shard —
and the cluster machinery — keeps serving; recovery replays that shard's
WAL through the untouched ``DB.reopen_gen``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from ..core.middleware import AdmissionController
from ..lsm.db import DB, ScenarioConfig
from ..zoned.sim import Sim
from .crash import kill_shard
from .router import INF, HashRouter, RangeRouter

SPLIT_CHUNK = 256   # keys copied per charged batch read during a split


def live_keys_in_range(tree, lo: int, hi) -> List[int]:
    """Live (non-tombstoned) keys of ``[lo, hi)`` (``hi`` may be INF),
    deduplicated newest-first exactly like ``LSMTree.scan`` — memtables
    (active, immutable, flushing), then L0 newest-first, then deeper
    levels.  Pure in-memory enumeration: the split's *charged* I/O comes
    from the batched reads/writes of the copy phase, not from listing."""
    newest: Dict[int, bool] = {}
    for m in [tree.memtable] + list(reversed(tree.immutables)) \
            + list(reversed(tree._flushing)):
        for k, (tomb, _) in m.data.items():
            if lo <= k and (hi is INF or k < hi):
                newest.setdefault(int(k), tomb)
    for lvl in range(len(tree.levels)):
        ssts = (sorted(tree.levels[0], key=lambda s: -s.birth)
                if lvl == 0 else tree.levels[lvl])
        for sst in ssts:
            a = int(np.searchsorted(sst.keys, np.uint64(lo)))
            b = (len(sst.keys) if hi is INF
                 else int(np.searchsorted(sst.keys, np.uint64(hi))))
            for i in range(a, b):
                newest.setdefault(int(sst.keys[i]), bool(sst.tombs[i]))
    return sorted(k for k, tomb in newest.items() if not tomb)


class RouterKV:
    """Routing op surface; same generator protocol as ``LSMTree``.

    Counters: ``routed[s]``/``completed[s]`` count kv calls begun/finished
    per shard; ``calls`` is their cluster total, so ``sum(routed) ==
    calls`` is an invariant the result validator checks per cell (note
    one *workload op* can be several kv calls: RMW is a get + a put, a
    scan touches every covering shard).  ``inflight[s]`` maps op tokens
    to key spans — the split drain and crash-loss accounting read it.
    """

    def __init__(self, cluster: "ShardedDB"):
        self.cluster = cluster
        n = len(cluster.shards)
        self.inflight: List[Dict[int, Tuple[int, Any, int]]] = \
            [{} for _ in range(n)]
        self.routed = [0] * n
        self.completed = [0] * n
        self.calls = 0
        self._tok = 0

    def snapshot(self) -> Tuple[int, List[int], List[int]]:
        return (self.calls, list(self.routed), list(self.completed))

    # -- admission / parking -------------------------------------------
    def _blocked(self, s: int, lo: int, hi) -> bool:
        c = self.cluster
        if s in c._down:
            return True
        st = c._split_state
        # op spans are finite; st["hi"] may be INF (suffix split)
        return (st is not None and s == st["src"]
                and lo < st["hi"] and hi > st["lo"])

    def _park(self):
        ev = self.cluster.sim.event()
        self.cluster._parked.append(ev)
        return ev

    def _admit(self, key: int):
        c = self.cluster
        while True:
            s = c.router.route(key)
            if not self._blocked(s, key, key + 1):
                return s
            yield self._park()

    def _begin(self, s: int, lo: int, hi, n: int = 1) -> int:
        self._tok += 1
        self.inflight[s][self._tok] = (lo, hi, n)
        self.routed[s] += n
        self.calls += n
        return self._tok

    def _end(self, s: int, tok: int, n: int = 1) -> None:
        if self.inflight[s].pop(tok, None) is not None:
            self.completed[s] += n
            c = self.cluster
            if c._split_state is not None and s == c._split_state["src"]:
                c._split_drain_check()

    # -- ops ------------------------------------------------------------
    def put(self, key: int, value: Optional[bytes] = None,
            tombstone: bool = False, tenant: Optional[str] = None):
        s = yield from self._admit(key)
        tok = self._begin(s, key, key + 1)
        try:
            res = yield from self.cluster.shards[s].tree.put(
                key, value, tombstone=tombstone, tenant=tenant)
        finally:
            self._end(s, tok)
        return res

    def delete(self, key: int):
        s = yield from self._admit(key)
        tok = self._begin(s, key, key + 1)
        try:
            res = yield from self.cluster.shards[s].tree.delete(key)
        finally:
            self._end(s, tok)
        return res

    def get(self, key: int):
        s = yield from self._admit(key)
        tok = self._begin(s, key, key + 1)
        try:
            res = yield from self.cluster.shards[s].tree.get(key)
        finally:
            self._end(s, tok)
        return res

    def get_batch(self, keys):
        """Batched point reads, re-grouped by owning shard; per-shard
        sub-batches keep the caller's key order, so a 1-shard cluster
        issues the identical single ``LSMTree.get_batch`` call."""
        keys = list(keys)
        c = self.cluster
        results: List[Any] = [None] * len(keys)
        remaining = list(range(len(keys)))
        while remaining:
            s = c.router.route(keys[remaining[0]])
            idxs = [i for i in remaining if c.router.route(keys[i]) == s]
            lo = min(keys[i] for i in idxs)
            hi = max(keys[i] for i in idxs) + 1
            if self._blocked(s, lo, hi):
                # routing may change while parked: re-group from scratch
                yield self._park()
                continue
            sub = [keys[i] for i in idxs]
            tok = self._begin(s, lo, hi, n=len(sub))
            try:
                res = yield from c.shards[s].tree.get_batch(sub)
            finally:
                self._end(s, tok, n=len(sub))
            for i, r in zip(idxs, res):
                results[i] = r
            drop = set(idxs)
            remaining = [i for i in remaining if i not in drop]
        return results

    def scan(self, start_key: int, count: int):
        """Range scan; returns the summed live-key count.

        Range routing consults only the shards *owning* a piece of the
        range — stale copies left on a shard by an aborted split are
        shadowed by ownership and never counted.  Hash routing scatters
        every range over all shards (disjoint key sets, exact sum)."""
        c = self.cluster
        end = start_key + count
        total = 0
        if c.router.kind == "range":
            while True:
                segs = c.router.covering_segments(start_key, end)
                if not any(self._blocked(s, lo, hi) for lo, hi, s in segs):
                    break
                yield self._park()
            for lo, hi, s in segs:
                tok = self._begin(s, int(lo), int(hi))
                try:
                    n = yield from c.shards[s].tree.scan(
                        int(lo), int(hi) - int(lo))
                finally:
                    self._end(s, tok)
                total += n
        else:
            for s in range(len(c.shards)):
                while self._blocked(s, start_key, end):
                    yield self._park()
                tok = self._begin(s, start_key, end)
                try:
                    n = yield from c.shards[s].tree.scan(start_key, count)
                finally:
                    self._end(s, tok)
                total += n
        return total


class ShardedDB:
    """Shard router fronting N per-shard ``DB`` instances (own devices,
    WAL, hint pipeline each) behind the single-store facade."""

    def __init__(self, scheme: str = "HHZS",
                 scenario: Optional[ScenarioConfig] = None,
                 shards: int = 2, routing: str = "hash",
                 key_space: Optional[int] = None,
                 rebalance: bool = False,
                 rebalance_period: float = 30.0,
                 rebalance_factor: float = 2.0,
                 store_values: bool = False,
                 admission: Any = "none",
                 telemetry: "bool | float" = False,
                 torch_device: str = "cuda"):
        if shards < 1:
            raise ValueError(f"shards must be >= 1: {shards}")
        self.sim = Sim()
        # every shard keeps its own filter image resident on torch_device
        self.shards: List[DB] = [
            DB(scheme, scenario, store_values=store_values, sim=self.sim,
               torch_device=torch_device)
            for _ in range(shards)]
        self.scheme = scheme
        self.scenario = self.shards[0].scenario
        self.routing = routing
        if routing == "hash":
            self.router: "HashRouter | RangeRouter" = HashRouter(shards)
        elif routing == "range":
            ks = key_space if key_space is not None \
                else self.scenario.paper_keys
            self.router = RangeRouter(shards, ks)
        else:
            raise ValueError(
                f"unknown routing {routing!r}; one of ('hash', 'range')")
        self.kv = RouterKV(self)
        # cluster-level admission: no single backend — per-shard WAL
        # pressure callbacks feed the controller instead
        self.admission = AdmissionController(self.sim, None, admission)
        self.admission.shard_pressure = [
            db.backend.wal_pressure for db in self.shards]
        self.admission.debt_gauge = lambda: float(self.compaction_debt())
        self._down: Set[int] = set()
        self._parked: List = []
        self._split_state: Optional[Dict[str, Any]] = None
        self._split_epoch = 0
        self.splits: List[Dict[str, Any]] = []
        self._crashed = False
        self.recovery: Optional[dict] = None
        self.metrics = None
        self.rebalance = bool(rebalance)
        self.rebalance_period = float(rebalance_period)
        self.rebalance_factor = float(rebalance_factor)
        if telemetry:
            self.enable_telemetry(
                5.0 if telemetry is True else float(telemetry))
        if rebalance:
            if routing != "range":
                raise ValueError("rebalance requires routing='range' "
                                 "(hash shards have no ranges to move)")
            if self.metrics is None:
                self.enable_telemetry()
            self.sim.process(self._rebalance_loop())

    # ---- single-store facade ------------------------------------------
    @property
    def now(self) -> float:
        return self.sim.now

    def submit(self, gen, tenant: Optional[str] = None):
        if tenant is not None:
            return self.admission.submit(gen, tenant)
        return self.sim.process(gen)

    def run_for(self, seconds: float) -> None:
        self.sim.run(until=self.sim.now + seconds)

    def drain(self) -> None:
        self.sim.run()

    def _run(self, gen):
        return self.sim.run_until(self.sim.process(gen))

    def put(self, key: int, value: Optional[bytes] = None):
        return self._run(self.kv.put(key, value))

    def get(self, key: int):
        return self._run(self.kv.get(key))

    def get_batch(self, keys):
        return self._run(self.kv.get_batch(list(keys)))

    def delete(self, key: int):
        return self._run(self.kv.delete(key))

    def scan(self, start_key: int, count: int):
        return self._run(self.kv.scan(start_key, count))

    def flush_all(self):
        def gen():
            for db in self.shards:
                yield from db.tree.flush_all()
        return self._run(gen())

    def compaction_debt(self) -> float:
        return float(sum(db.tree.compaction_debt() for db in self.shards))

    _RATE_EXTRAS = ("block_cache_hit_rate",)

    def extras(self) -> dict:
        parts = [db.extras() for db in self.shards]
        if len(parts) == 1:
            return parts[0]
        keys: List[str] = []
        for part in parts:
            for k in part:
                if k not in keys:
                    keys.append(k)
        out: Dict[str, Any] = {}
        for k in keys:
            vals = [p[k] for p in parts if k in p]
            out[k] = (sum(vals) / len(vals) if k in self._RATE_EXTRAS
                      else sum(vals))
        return out

    def fresh_admission(self, policy=None) -> AdmissionController:
        orig_base = self.admission.base_cfg
        self.admission = AdmissionController(
            self.sim, None, policy if policy is not None else orig_base)
        self.admission.base_cfg = orig_base
        self.admission.shard_pressure = [
            db.backend.wal_pressure for db in self.shards]
        self.admission.debt_gauge = lambda: float(self.compaction_debt())
        if self.metrics is not None:
            self.admission.install_metrics(self.metrics)
        return self.admission

    # ---- telemetry -----------------------------------------------------
    def enable_telemetry(self, sample_period: float = 5.0,
                         capacity: int = 720):
        """Per-shard signals under ``s{i}.``, cluster rollups under
        ``cluster.*`` (aggregated at sample time so shard reopens that
        rebind gauges are picked up), and the per-shard op-rate series
        the rebalancer reads.  Idempotent."""
        if self.metrics is not None:
            return self.metrics
        from ..obs import MetricsRegistry
        reg = MetricsRegistry(self.sim, sample_period, capacity)
        self.metrics = reg
        n = len(self.shards)
        for i, db in enumerate(self.shards):
            db.ssd.install_metrics(reg, f"s{i}.ssd")
            db.hdd.install_metrics(reg, f"s{i}.hdd")
            db.backend.install_metrics(reg, f"s{i}.")
            db.tree.install_metrics(reg, f"s{i}.")
        for name, red in (("lsm.debt", "sum"), ("lsm.l0_files", "sum"),
                          ("lsm.flush_backlog", "sum"),
                          ("lsm.write_amp", "mean"),
                          ("mw.wal_pressure", "max"),
                          ("ssd.util", "mean"), ("hdd.util", "mean")):
            reg.aggregate_gauge(f"cluster.{name}",
                                [f"s{i}.{name}" for i in range(n)], red)
        reg.collector(self._shard_op_rates, rate=True,
                      name="cluster.shard_ops")
        self.admission.install_metrics(reg)
        reg.start()
        return reg

    def _shard_op_rates(self) -> Dict[str, float]:
        return {f"cluster.s{i}.op_rate": float(v)
                for i, v in enumerate(self.kv.routed)}

    # ---- per-shard crash / recovery ------------------------------------
    def crash_shard(self, idx: int) -> Dict[str, Any]:
        """Power-loss shard ``idx`` only; every other shard keeps serving.

        In-flight ops on the shard die with it (their processes are
        surgically removed from the shared kernel and pinned); ops routed
        to it afterwards park and complete after ``reopen_shard``.  An
        active split touching the shard rolls back (routing unchanged)."""
        db = self.shards[idx]
        if db._crashed:
            raise RuntimeError(f"shard {idx} already crashed")
        killed = kill_shard(self.sim, db)
        lost = sum(n for (_, _, n) in self.kv.inflight[idx].values())
        # killed processes never run their finally blocks: clear their
        # tokens here so routed - completed = lost ops, exactly
        self.kv.inflight[idx].clear()
        self._down.add(idx)
        self._abort_split_for(idx)
        return {"shard": idx, "lost_in_flight": lost,
                "killed_processes": killed}

    def reopen_shard_gen(self, idx: int):
        """Generator: recover shard ``idx`` (charged WAL replay via the
        untouched ``DB.reopen_gen``), then release parked ops."""
        db = self.shards[idx]
        rec = dict((yield from db.reopen_gen()))
        self._down.discard(idx)
        self._release_parked()
        if self.metrics is not None:
            # rebind the per-shard tree gauges to the recovered tree (the
            # registry replaces by name; devices/backend survived intact)
            db.tree.install_metrics(self.metrics, f"s{idx}.")
        rec["shard"] = idx
        self.recovery = rec
        return rec

    def reopen_shard(self, idx: int) -> dict:
        return self._run(self.reopen_shard_gen(idx))

    # ---- whole-cluster crash / recovery (DB.crash parity) --------------
    def crash(self) -> None:
        """Whole-cluster power loss: the ``DB.crash`` protocol applied to
        every shard at once (single heap clear; see that docstring)."""
        sim = self.sim
        g = sim.graveyard
        g.append(list(sim._heap))
        for db in self.shards:
            g.extend([db.backend._wal_waiters, db.backend._wal_queue,
                      db.tree._stall_waiters, db.tree._flush_watchers,
                      db.tree.jobs._queue, db.tree])
        g.append(self._parked)
        self._parked = []
        for q in sim._mono:
            g.append(q.crash_clear())
        sim._heap.clear()
        sim._live = 0
        for db in self.shards:
            for dev in (db.ssd, db.hdd):
                dev.restart()
            db.backend.crash_volatile()
            db._crashed = True
        for d in self.kv.inflight:
            d.clear()
        if self._split_state is not None:
            self._split_epoch += 1
            self._split_state = None
        self._down = set()
        self._crashed = True

    def reopen_gen(self):
        recs = []
        for i, db in enumerate(self.shards):
            recs.append((yield from db.reopen_gen()))
            if self.metrics is not None:
                db.tree.install_metrics(self.metrics, f"s{i}.")
        if self.metrics is not None:
            self.metrics.restart()
        self._crashed = False
        self.recovery = {
            "at": self.sim.now,
            "live_wal_zones": sum(r["live_wal_zones"] for r in recs),
            "replayed_gens": sum(r["replayed_gens"] for r in recs),
            "replayed_records": sum(r["replayed_records"] for r in recs)}
        return self.recovery

    def reopen(self) -> dict:
        return self._run(self.reopen_gen())

    # ---- online split ---------------------------------------------------
    def split(self, lo: int, hi, dst: int):
        """Spawn the online move of range ``[lo, hi)`` (``hi`` may be
        ``INF``) to shard ``dst``; returns the Process."""
        return self.sim.process(self._split_proc(lo, hi, dst))

    def _split_proc(self, lo: int, hi, dst: int):
        if self.router.kind != "range":
            raise ValueError("online splits require routing='range'")
        if self._split_state is not None:
            return {"completed": False, "reason": "split already active"}
        owners = self.router.shards_for_range(lo, hi)
        if len(owners) != 1:
            return {"completed": False,
                    "reason": f"range spans shards {owners}"}
        src = owners[0]
        if src == dst:
            return {"completed": False, "reason": "src == dst"}
        if src in self._down or dst in self._down:
            return {"completed": False, "reason": "endpoint shard is down"}
        epoch = self._split_epoch
        st: Dict[str, Any] = {"src": src, "dst": dst, "lo": lo, "hi": hi,
                              "drain_ev": None}
        self._split_state = st
        t0 = self.sim.now
        aborted = {"completed": False, "reason": "aborted by shard crash"}
        # phase 1 — drain: in-flight ops overlapping the range finish
        # (ops on the retained range keep flowing; new overlapping ops
        # park at the router until the flip or the abort)
        while self._overlapping_inflight(st):
            ev = self.sim.event()
            st["drain_ev"] = ev
            yield ev
            if self._split_epoch != epoch:
                return aborted
        src_db, dst_db = self.shards[src], self.shards[dst]
        # phase 2 — copy, charged in virtual time: batched reads on the
        # source, full write path (WAL, memtable, flush) on the target
        keys = live_keys_in_range(src_db.tree, lo, hi)
        have = set(keys)
        moved = 0
        for off in range(0, len(keys), SPLIT_CHUNK):
            chunk = keys[off:off + SPLIT_CHUNK]
            vals = yield from src_db.tree.get_batch(chunk)
            if self._split_epoch != epoch:
                return aborted
            for k, (found, val) in zip(chunk, vals):
                yield from dst_db.tree.put(int(k), val)
                if self._split_epoch != epoch:
                    return aborted
            moved += len(chunk)
        # phase 3 — reconcile: a key live on the target but absent from
        # the source's live set is residue of an earlier aborted/backward
        # split; tombstone it or it would resurrect after the flip
        tombs = 0
        for k in live_keys_in_range(dst_db.tree, lo, hi):
            if k not in have:
                yield from dst_db.tree.delete(int(k))
                if self._split_epoch != epoch:
                    return aborted
                tombs += 1
        # phase 4 — atomic flip (plain state mutation between DES
        # events) and release of the parked ops
        self.router.reassign(lo, hi, dst)
        self._split_state = None
        self._release_parked()
        rec = {"completed": True, "src": src, "dst": dst, "lo": int(lo),
               "hi": None if hi is INF else int(hi), "moved_keys": moved,
               "reconciled": tombs, "t0": t0, "t1": self.sim.now}
        self.splits.append(rec)
        return rec

    def _overlapping_inflight(self, st: Dict[str, Any]) -> bool:
        lo, hi = st["lo"], st["hi"]
        for (a, b, _n) in self.kv.inflight[st["src"]].values():
            if a < hi and b > lo:
                return True
        return False

    def _split_drain_check(self) -> None:
        st = self._split_state
        if st is not None and st["drain_ev"] is not None \
                and not self._overlapping_inflight(st):
            ev = st["drain_ev"]
            st["drain_ev"] = None
            ev.succeed()

    def _abort_split_for(self, idx: int) -> None:
        """Roll back an active split touching crashed shard ``idx``:
        routing stays on the source (never half-flipped); copies already
        written to the target are shadowed by ownership and reconciled
        by the next successful split of that range."""
        st = self._split_state
        if st is None or idx not in (st["src"], st["dst"]):
            return
        self._split_epoch += 1
        self._split_state = None
        self.splits.append({
            "completed": False, "src": st["src"], "dst": st["dst"],
            "lo": int(st["lo"]),
            "hi": None if st["hi"] is INF else int(st["hi"]),
            "reason": f"shard {idx} crashed mid-split", "at": self.sim.now})
        ev = st["drain_ev"]
        if ev is not None and not ev.triggered:
            # the split process survives a source crash during drain
            # (it is suspended in cluster code); wake it to observe the
            # epoch bump and abort
            ev.succeed()
        self._release_parked()

    def _release_parked(self) -> None:
        parked, self._parked = self._parked, []
        for ev in parked:
            ev.succeed()

    # ---- rebalancer -----------------------------------------------------
    def _rebalance_loop(self):
        while True:
            yield self.sim.timeout(self.rebalance_period, daemon=True)
            self._maybe_rebalance()

    def _maybe_rebalance(self) -> None:
        if self._split_state is not None or len(self.shards) < 2:
            return
        reg = self.metrics
        rates = []
        for i in range(len(self.shards)):
            v = reg.latest(f"cluster.s{i}.op_rate")
            rates.append(0.0 if v is None else float(v))
        total = sum(rates)
        if total <= 0.0:
            return
        n = len(rates)
        hot = max(range(n), key=rates.__getitem__)
        cold = min(range(n), key=rates.__getitem__)
        if hot == cold or hot in self._down or cold in self._down:
            return
        if rates[hot] < self.rebalance_factor * (total / n):
            return
        # shed the *head* of the hot shard's most populous segment, cut
        # at the sqrt quantile: skewed range traffic (a zipf-popular hot
        # spot anchored at the segment head) has its mass median around
        # the sqrt(W)-th key, so the handed-off head [lo, mid) carries
        # ~half the traffic while containing only ~sqrt(W) keys — a
        # cheap bulk copy with a large routing effect.  A key-median
        # split would strand nearly all of the zipf head on the source
        # shard, and handing off the tail instead would bulk-copy
        # W - sqrt(W) keys for the same traffic relief.
        best: Optional[Tuple[int, Any, List[int]]] = None
        for lo, hi in self.router.segments_of(hot):
            keys = live_keys_in_range(self.shards[hot].tree, lo, hi)
            if best is None or len(keys) > len(best[2]):
                best = (lo, hi, keys)
        if best is None or len(best[2]) < 2:
            return
        lo, hi, keys = best
        cut = max(1, math.isqrt(len(keys)))
        mid = int(keys[cut])
        if mid <= lo or not (hi is INF or mid < hi):
            return
        self.split(lo, mid, cold)

    # ---- result-row helpers ---------------------------------------------
    def shard_stats(self, baseline: Optional[Tuple[int, List[int],
                                                   List[int]]] = None
                    ) -> List[Dict[str, Any]]:
        """Per-shard accounting rows; ``baseline`` (a ``RouterKV.snapshot``
        taken before the measured phase) subtracts load-phase traffic."""
        n = len(self.shards)
        _, routed0, completed0 = baseline or (0, [0] * n, [0] * n)
        rows = []
        for i, db in enumerate(self.shards):
            r = self.kv.routed[i] - routed0[i]
            done = self.kv.completed[i] - completed0[i]
            rows.append({
                "shard": i,
                "kv_ops": r,
                "kv_completed": done,
                "availability": (done / r) if r else 1.0,
                "ssd_read_bytes": db.ssd.counters.read_bytes,
                "ssd_write_bytes": db.ssd.counters.write_bytes,
                "hdd_read_bytes": db.hdd.counters.read_bytes,
                "hdd_write_bytes": db.hdd.counters.write_bytes,
                "compaction_debt": float(db.tree.compaction_debt()),
            })
        return rows
