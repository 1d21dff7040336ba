"""YCSB-style workload generation + closed-loop client runner.

The six core workloads (§4 Exp#1) and the W1-W4 mixes of Exp#2 are expressed
as ``WorkloadSpec``s.  Key popularity follows a Zipf distribution with
parameter alpha over *scrambled* key ranks (YCSB hashes keys, so hot keys are
scattered across the key space and therefore across SSTs).  Workload D reads
the most recently inserted keys ("latest" distribution).

The runner drives N closed-loop client processes against the simulated DB
and records per-operation latency in virtual time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import numpy as np

# op codes
READ, UPDATE, INSERT, SCAN, RMW = 0, 1, 2, 3, 4
OP_NAMES = {READ: "read", UPDATE: "update", INSERT: "insert",
            SCAN: "scan", RMW: "rmw"}


@dataclass(frozen=True)
class WorkloadSpec:
    name: str
    read: float = 0.0
    update: float = 0.0
    insert: float = 0.0
    scan: float = 0.0
    rmw: float = 0.0
    dist: str = "zipf"        # "zipf" | "latest" | "hotspot"
    alpha: float = 0.9
    scan_max: int = 100
    # "hotspot" distribution: zipf-popular ranks map to a *contiguous*
    # key range (no scramble) whose base drifts by ``hotspot_step`` keys
    # on a schedule — a moving hot spot in keyspace, the adversarial load
    # for range sharding (the hot range concentrates on one shard, then
    # walks off it).  ``hotspot_step`` semantics:
    #   "auto" -> n_keys // 8, resolved when the stream is built
    #   0      -> stationary hotspot (no drift)
    #   k > 0  -> walk by k keys per period
    # The walk schedule is ``hotspot_period_s`` *virtual seconds* when
    # set (schemes at different service rates see the same hot range at
    # the same virtual time — the drift-trace mode), else every
    # ``hotspot_period`` *ops* (legacy op-index mode, kept for backward
    # compat: it advances at the stream's own service rate).
    hotspot_period: int = 2000
    hotspot_step: Union[int, str] = "auto"
    hotspot_period_s: Optional[float] = None

    def mix(self):
        return np.array([self.read, self.update, self.insert,
                         self.scan, self.rmw], dtype=np.float64)


# The six YCSB core workloads (Exp#1), alpha=0.9 per the paper ([28] default)
YCSB = {
    "A": WorkloadSpec("A", read=0.5, update=0.5),
    "B": WorkloadSpec("B", read=0.95, update=0.05),
    "C": WorkloadSpec("C", read=1.0),
    "D": WorkloadSpec("D", read=0.95, insert=0.05, dist="latest"),
    "E": WorkloadSpec("E", scan=0.95, insert=0.05),
    "F": WorkloadSpec("F", read=0.5, rmw=0.5),
}


def mixed(name: str, read_frac: float, alpha: float) -> WorkloadSpec:
    """Exp#2-4 style workloads: read/update mixes at a given skewness."""
    return WorkloadSpec(name, read=read_frac, update=1.0 - read_frac,
                        alpha=alpha)


def zipf_probs(n: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return p / p.sum()


@dataclass
class Ops:
    codes: np.ndarray       # int8 op codes
    args: np.ndarray        # int64: zipf rank / recency offset / scan len<<32|rank
    scan_lens: np.ndarray   # int32


def generate_ops(spec: WorkloadSpec, n_ops: int, n_keys: int,
                 seed: int = 0) -> Ops:
    rng = np.random.default_rng(seed)
    codes = rng.choice(5, size=n_ops, p=spec.mix() / spec.mix().sum())
    p = zipf_probs(n_keys, spec.alpha)
    ranks = rng.choice(n_keys, size=n_ops, p=p)
    scan_lens = rng.integers(1, spec.scan_max + 1, size=n_ops,
                             dtype=np.int32)
    return Ops(codes=codes.astype(np.int8), args=ranks.astype(np.int64),
               scan_lens=scan_lens)


@dataclass
class WorkloadResult:
    name: str
    scheme: str
    n_ops: int
    duration: float
    throughput: float                     # OPS in virtual time
    latency_p: Dict[str, float]           # percentiles over all ops
    read_latency_p: Dict[str, float]      # percentiles over reads only
    op_counts: Dict[str, int]
    extras: Dict[str, float]

    def row(self) -> str:
        return (f"{self.scheme:7s} {self.name:6s} ops={self.n_ops} "
                f"dur={self.duration:9.3f}s thpt={self.throughput:10.1f} OPS "
                f"p99={self.latency_p.get('p99', 0)*1e3:8.3f}ms")


_PCTS = {"p50": 50, "p90": 90, "p99": 99, "p999": 99.9, "p9999": 99.99}


def _pct(lat: np.ndarray) -> Dict[str, float]:
    if len(lat) == 0:
        return {k: 0.0 for k in _PCTS}
    return {k: float(np.percentile(lat, q)) for k, q in _PCTS.items()}


class OpStream:
    """Pre-generated op stream + key resolution, shared by the closed-loop
    runner below and the open-loop engine (``repro_torch.workloads.runner``).

    Key resolution semantics (scrambled Zipf popularity, "latest" reads
    against the insert frontier, frontier-advancing inserts) live here so
    every runner drives the tree identically.
    """

    def __init__(self, db, spec: WorkloadSpec, n_ops: int, n_keys: int,
                 seed: int = 1):
        self.spec = spec
        self.ops = generate_ops(spec, n_ops, n_keys, seed=seed)
        self.n_ops = n_ops
        self.n_keys = n_keys
        # scrambled popularity: zipf rank -> key id
        self.scramble = np.random.default_rng(seed + 1) \
            .permutation(n_keys).astype(np.int64)
        self.load_order = getattr(db, "load_order",
                                  np.arange(n_keys, dtype=np.int64))
        # the insert frontier starts at the number of keys actually
        # loaded, not at n_keys: a stream may declare a keyspace larger
        # than the loaded prefix (drift "grow" phases) and the gap is
        # filled by frontier-advancing inserts, never by load_order
        self._loaded = min(n_keys, len(self.load_order))
        self.frontier = self._loaded      # total inserted keys (D/E inserts)
        self.db = db
        self.counts = {name: 0 for name in OP_NAMES.values()}
        step = spec.hotspot_step
        self._hot_step = max(1, n_keys // 8) if step == "auto" else int(step)
        # virtual-time origin for the hotspot_period_s walk: drift is
        # measured from stream creation, not absolute sim time (load
        # phases of different lengths must not offset the schedule)
        self._t0 = float(db.sim.now)
        # originating tenant for write attribution (set by the
        # multi-tenant runner): rides every put() into the tree, tagging
        # flushed bytes for per-tenant compaction-debt attribution
        self.tenant: Optional[str] = None

    @property
    def tree(self):
        # resolved per-op, not cached: DB.reopen() swaps in a fresh tree
        # (or the sharded facade re-routes) and queued ops must not write
        # into discarded state
        return self.db.kv

    def resolve(self, code: int, rank: int, i: int = 0) -> int:
        if self.spec.dist == "latest" and code == READ:
            # most-recent first: offset `rank` back from the insert frontier
            off = self.frontier - 1 - rank
            if off < 0:
                off = 0
            return int(self.load_order[off]) if off < self._loaded else off
        if self.spec.dist == "hotspot":
            # contiguous drifting hot range: popular ranks land next to
            # each other in keyspace (deliberately unscrambled) and the
            # base walks every hotspot_period_s virtual seconds (or, in
            # the legacy mode, every hotspot_period ops)
            if self.spec.hotspot_period_s:
                epoch = int((self.db.sim.now - self._t0)
                            // self.spec.hotspot_period_s)
            else:
                epoch = i // max(1, self.spec.hotspot_period)
            return int((rank + epoch * self._hot_step) % self.n_keys)
        return int(self.scramble[rank % self.n_keys])

    def is_point_read(self, i: int) -> bool:
        """Whether op ``i`` is a point READ (batchable by the open-loop
        runner's vectorized-probe read path)."""
        return int(self.ops.codes[i]) == READ

    def execute_read_batch(self, idxs):
        """Generator servicing several point READs in one
        ``LSMTree.get_batch`` call (vectorized Bloom probing).  Result-
        identical to executing them one by one; only service timing and
        python overhead differ."""
        keys = [self.resolve(READ, int(self.ops.args[i]), int(i))
                for i in idxs]
        res = yield from self.tree.get_batch(keys)
        self.counts["read"] += len(idxs)
        return res

    def execute(self, i: int):
        """Generator running op ``i`` against the tree (virtual-timed)."""
        code = int(self.ops.codes[i])
        rank = int(self.ops.args[i])
        # tenant tag only when set: untagged streams call put(key) exactly
        # as before, keeping single-stream runs event-for-event unchanged
        kw = {"tenant": self.tenant} if self.tenant is not None else {}
        if code == READ:
            yield from self.tree.get(self.resolve(code, rank, i))
        elif code == UPDATE:
            yield from self.tree.put(self.resolve(code, rank, i), **kw)
        elif code == INSERT:
            key = self.frontier
            self.frontier += 1
            yield from self.tree.put(key, **kw)
        elif code == SCAN:
            yield from self.tree.scan(self.resolve(code, rank, i),
                                      int(self.ops.scan_lens[i]))
        elif code == RMW:
            key = self.resolve(code, rank, i)
            yield from self.tree.get(key)
            yield from self.tree.put(key, **kw)
        self.counts[OP_NAMES[code]] += 1


def collect_extras(db) -> Dict[str, float]:
    """Device/cache/migration counters attached to every result row —
    delegated to the store (``DB.extras`` / ``ShardedDB.extras``, which
    aggregates across shards)."""
    return db.extras()


def run_load(db, n_keys: int, num_clients: int = 16, seed: int = 42,
             sampler=None) -> WorkloadResult:
    """Load phase: insert all keys in scrambled order."""
    rng = np.random.default_rng(seed)
    load_order = rng.permutation(n_keys).astype(np.int64)
    db.load_order = load_order          # recency mapping for workload D
    tree, sim = db.kv, db.sim
    t0 = sim.now
    lat: List[float] = []
    cursor = {"i": 0}

    def client():
        while True:
            i = cursor["i"]
            if i >= n_keys:
                return
            cursor["i"] += 1
            s = sim.now
            yield from tree.put(int(load_order[i]))
            lat.append(sim.now - s)

    procs = [sim.process(client()) for _ in range(num_clients)]
    for p in procs:
        sim.run_until(p)
    dur = sim.now - t0
    lat_arr = np.asarray(lat)
    return WorkloadResult(
        name="load", scheme=db.scheme, n_ops=n_keys, duration=dur,
        throughput=n_keys / max(dur, 1e-12), latency_p=_pct(lat_arr),
        read_latency_p={}, op_counts={"insert": n_keys},
        extras={})


def run_workload(db, spec: WorkloadSpec, n_ops: int, n_keys: int,
                 num_clients: int = 16, seed: int = 1) -> WorkloadResult:
    """Run phase: closed-loop clients over a pre-generated op stream."""
    stream = OpStream(db, spec, n_ops, n_keys, seed=seed)
    sim = db.sim
    t0 = sim.now
    lat = np.zeros(n_ops, np.float64)
    cursor = {"i": 0}

    def client():
        while True:
            i = cursor["i"]
            if i >= n_ops:
                return
            cursor["i"] += 1
            s = sim.now
            yield from stream.execute(i)
            lat[i] = sim.now - s

    procs = [sim.process(client()) for _ in range(num_clients)]
    for p in procs:
        sim.run_until(p)
    dur = sim.now - t0
    reads_mask = stream.ops.codes == READ
    return WorkloadResult(
        name=spec.name, scheme=db.scheme, n_ops=n_ops, duration=dur,
        throughput=n_ops / max(dur, 1e-12),
        latency_p=_pct(lat), read_latency_p=_pct(lat[reads_mask]),
        op_counts=stream.counts, extras=collect_extras(db))


class LevelSampler:
    """Samples actual level sizes every ``period`` (O1, Fig. 2a)."""

    def __init__(self, db, period: float = 60.0):
        self.db = db
        self.period = period
        self.samples: List[List[int]] = []
        self.wal_samples: List[int] = []
        db.sim.process(self._run())

    def _run(self):
        while True:
            yield self.db.sim.timeout(self.period, daemon=True)
            self.samples.append(self.db.tree.level_sizes())
            self.wal_samples.append(self.db.backend.wal_zones_in_use())

    def stats(self):
        if not self.samples:
            return None
        arr = np.asarray(self.samples, dtype=np.float64)
        return {
            "min": arr.min(axis=0), "max": arr.max(axis=0),
            "median": np.median(arr, axis=0),
            "q1": np.percentile(arr, 25, axis=0),
            "q3": np.percentile(arr, 75, axis=0),
        }
