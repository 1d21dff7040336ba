"""The port's sharded cluster held against the JAX package.

``repro_torch.cluster`` (router, per-shard crash, online split and
rebalancer over N shard stores on one DES clock) and ``repro.cluster``
take the same seeded op sequences on ``tiny_scenario()`` shards (the
port's at ``torch_device="cpu"``, asked for explicitly: here there is no
card); answers, router state, split records, virtual clocks and scenario
rows must be equal, byte for byte as JSON.  The port's own contracts are
held beside: a 1-shard cluster replays a bare store event for event, and
the router conserves its calls.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_scenario  # noqa: E402
from repro import cluster as ref_cluster  # noqa: E402
from repro import workloads as ref_wl  # noqa: E402
from repro.lsm import DB as RefDB, SCHEMES  # noqa: E402
from repro.workloads import sweep as ref_sweep  # noqa: E402
from repro.zoned import faults as ref_faults  # noqa: E402
import repro_torch.lsm as pt_lsm  # noqa: E402
from repro_torch import cluster as pt_cluster  # noqa: E402
from repro_torch import workloads as pt_wl  # noqa: E402
from repro_torch.workloads import sweep as pt_sweep  # noqa: E402
from repro_torch.zoned import faults as pt_faults  # noqa: E402
from test_torch_store import port_scenario  # noqa: E402


class _Pkg:
    def __init__(self, name, cluster, wl, sweep, faults, db, device):
        self.name, self.cluster, self.wl = name, cluster, wl
        self.sweep, self.faults, self.device = sweep, faults, device
        self._db = db

    def scenario(self, sc):
        return sc if self.name == "ref" else port_scenario(sc)

    def db(self, scheme, **kw):
        return self._db(scheme, self.scenario(tiny_scenario()),
                        store_values=True, **self.device, **kw)

    def sharded(self, scheme="HHZS", **kw):
        return self.cluster.ShardedDB(scheme, self.scenario(tiny_scenario()),
                                      store_values=True, **self.device, **kw)


REF = _Pkg("ref", ref_cluster, ref_wl, ref_sweep, ref_faults, RefDB, {})
PORT = _Pkg("port", pt_cluster, pt_wl, pt_sweep, pt_faults, pt_lsm.DB,
            {"torch_device": "cpu"})


def _both(drive):
    """``drive(pkg)`` on each package; the port's result, after checking
    it equals the reference's byte for byte."""
    ref, port = (json.dumps(drive(pkg), sort_keys=True, default=repr)
                 for pkg in (REF, PORT))
    assert port == ref
    return json.loads(port)


def _kv_sequence(seed=7, n_ops=260, key_space=300):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        key = int(rng.integers(key_space))
        if r < 0.45:
            ops.append(("put", key,
                        b"v%d-%d" % (key, int(rng.integers(1 << 16)))))
        elif r < 0.70:
            ops.append(("get", key, None))
        elif r < 0.85:
            ops.append(("del", key, None))
        else:
            ops.append(("scan", key, int(rng.integers(1, 20))))
    return ops


def _drive(store, ops):
    """Answers as JSON-able lists, the batched reads' too, and the clock."""
    out = []
    for op, key, arg in ops:
        if op == "put":
            store.put(key, arg)
        elif op == "del":
            store.delete(key)
        elif op == "get":
            found, val = store.get(key)
            out.append(["get", key, found, repr(val)])
        else:
            out.append(["scan", key, store.scan(key, arg)])
    got = store.get_batch(list(range(0, 300, 7)))
    out.append(["batch", [[f, repr(v)] for f, v in got]])
    store.drain()
    out.append(["now", store.sim.now])
    return out


# ----------------------------------------------------------------------
# 1-shard equivalence and multi-shard answers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("scheme", SCHEMES)
def test_one_shard_is_event_identical_to_bare_db(scheme):
    """The router adds no yield on the unblocked path: a 1-shard cluster
    replays the bare store exactly (answers and clock), in the port, and
    both replay the reference's bare store."""
    ops = _kv_sequence()
    bare = _both(lambda pkg: _drive(pkg.db(scheme), ops))
    one = _both(lambda pkg: _drive(pkg.sharded(scheme, shards=1,
                                               routing="hash"), ops))
    assert one == bare


def test_one_shard_range_routing_also_identical():
    ops = _kv_sequence(seed=11)
    bare = _both(lambda pkg: _drive(pkg.db("HHZS"), ops))
    one = _both(lambda pkg: _drive(pkg.sharded(shards=1, routing="range",
                                               key_space=300), ops))
    assert one == bare


@pytest.mark.parametrize("routing", ["hash", "range"])
def test_multi_shard_answers_match_model_and_reference(routing):
    """Three shards: every answer is the model's and the reference's, the
    router conserves its calls, and the per-shard stats rows match."""
    ops = _kv_sequence(seed=3, n_ops=300)
    model = {}
    for op, key, arg in ops:
        if op == "put":
            model[key] = arg
        elif op == "del":
            model.pop(key, None)

    def drive(pkg):
        db = pkg.sharded(shards=3, routing=routing, key_space=300)
        out = _drive(db, ops)
        return {"answers": out, "snapshot": list(db.kv.snapshot()),
                "stats": db.shard_stats()}
    got = _both(drive)
    calls, routed, completed = got["snapshot"]
    assert sum(routed) == calls and completed == routed
    for key in range(0, 300, 7):
        assert got["answers"][-2][1][key // 7] == \
            [key in model, repr(model.get(key))]


def test_routers_match_reference():
    """splitmix64 hash routing and range routing with reassignments."""
    def drive(pkg):
        h = pkg.cluster.HashRouter(4)
        r = pkg.cluster.RangeRouter(2, 100)
        r.reassign(10, 20, 1)
        segs = r.covering_segments(0, 100)
        r.reassign(80, pkg.cluster.INF, 0)
        return {"hash": [h.route(k) for k in range(4000)], "segs": segs,
                "range": [r.route(k) for k in range(0, 200, 3)],
                "for": r.shards_for_range(50, 80),
                "describe": r.describe()}
    got = _both(drive)
    assert set(got["hash"]) == {0, 1, 2, 3}


# ----------------------------------------------------------------------
# online splits and per-shard crashes
# ----------------------------------------------------------------------
def _loaded_cluster(pkg, shards=2, n=200):
    db = pkg.sharded(shards=shards, routing="range", key_space=n)
    for k in range(n):
        db.put(k, b"v%d" % k)
    db.drain()
    return db


def _split_case(pkg, case):
    db = _loaded_cluster(pkg)
    out = {}
    if case == "moves":
        out["res"] = db.sim.run_until(db.split(0, 50, 1))
    elif case == "in_flight":
        answers = []

        def reader(k):
            got = yield from db.kv.get(k)
            answers.append([k, got[0], repr(got[1])])
        for k in (1, 2, 3):
            db.submit(reader(k))
        proc = db.split(0, 50, 1)
        for k in (4, 5, 48, 49, 150):
            db.submit(reader(k))
        out["res"] = db.sim.run_until(proc)
        db.drain()
        out["answers"] = sorted(answers)
    elif case == "spanning":
        out["res"] = db.sim.run_until(db.split(50, 150, 1))
    else:                                   # the source crashes mid-split
        db.split(0, 50, 1)
        db.run_for(1e-6)
        rep = db.crash_shard(0)
        out["crash"] = [rep["shard"], rep["lost_in_flight"],
                        len(rep["killed_processes"])]
        out["mid"] = db.router.describe()
        db.sim.run_until(db.sim.process(db.reopen_shard_gen(0)))
        db.drain()
        out["res"] = db.sim.run_until(db.split(0, 50, 1))
    out["router"] = db.router.describe()
    out["splits"] = db.splits
    out["gets"] = [[k, *map(repr, db.get(k))] for k in range(0, 200, 7)]
    out["batch"] = [repr(a) for a in db.get_batch(list(range(0, 200, 9)))]
    out["now"] = db.sim.now
    out["snapshot"] = list(db.kv.snapshot())
    return out


@pytest.mark.parametrize("case", ["moves", "in_flight", "spanning",
                                  "source_crash"])
def test_split_matches_reference(case):
    """The split's copy (batched reads of the moving range), drain and
    flip: router, split records, answers and clock as the reference's."""
    got = _both(lambda pkg: _split_case(pkg, case))
    if case == "spanning":
        assert not got["res"]["completed"]
    else:
        assert got["res"]["completed"]
        assert all(g[1] == "True" for g in got["gets"])


def test_crashed_shard_parks_ops_then_drains_as_reference():
    def drive(pkg):
        db = _loaded_cluster(pkg)
        db.crash_shard(0)
        served, parked = [], []

        def reader(k, sink):
            got = yield from db.kv.get(k)
            sink.append([k, got[0], repr(got[1])])
        db.submit(reader(150, served))
        db.submit(reader(10, parked))
        db.run_for(5.0)
        before = list(parked)
        db.sim.run_until(db.sim.process(db.reopen_shard_gen(0)))
        db.drain()
        db.crash()
        db.reopen()
        db.drain()
        return {"served": served, "parked_before": before,
                "parked": parked, "snapshot": list(db.kv.snapshot()),
                "gets": [repr(db.get(k)) for k in range(0, 200, 11)],
                "now": db.sim.now}
    got = _both(drive)
    assert got["parked_before"] == [] and got["parked"] == \
        [[10, True, repr(b"v10")]]


# ----------------------------------------------------------------------
# sharded scenario cells
# ----------------------------------------------------------------------
def _cell_rows(pkg, cell):
    wl = pkg.wl
    factory = pkg.sweep.GridDBFactory(key_div=256, load_div=4,
                                      rebalance_period=5.0, **pkg.device)
    uni = wl.WorkloadSpec("shmix", read=0.5, update=0.5, alpha=0.01)
    common = dict(schemes=["HHZS"], ssd_zone_budgets=[20], duration=60.0,
                  warmup=5.0, key_div=256, db_factory=factory,
                  read_batch=16, **pkg.device)
    if cell == "crash":
        m = wl.ScenarioMatrix(
            workloads=[uni], arrivals=[wl.PoissonArrivals(80.0)],
            shards=[2], routing="range",
            faults=[pkg.faults.FaultSpec(name="crash-s1", crash_at=30.0,
                                         crash_shard=1,
                                         recovery_slo_s=10.0)], **common)
    elif cell == "rebalance":
        hot = wl.WorkloadSpec("shhot", read=0.5, update=0.5, alpha=0.99,
                              dist="hotspot", hotspot_period=1200,
                              hotspot_step=512)
        m = wl.ScenarioMatrix(
            workloads=[hot], arrivals=[wl.PoissonArrivals(80.0)],
            shards=[4], routing="range", rebalance=[False, True],
            telemetry=True, **common)
    else:
        m = wl.ScenarioMatrix(
            workloads=[uni], arrivals=[wl.PoissonArrivals(80.0)],
            shards=[1, 2, 3], routing="hash", **common)
    return pkg.sweep.run_sweep(m, out=None, workers=0, verbose=False)


@pytest.mark.parametrize("cell", ["crash", "rebalance", "scaling"])
def test_sharded_cells_match_reference(cell):
    """``bench_sharding``'s three legs at smoke size: a range cluster whose
    shard 1 crashes mid-run, a hot range on four shards with and without
    the rebalancer, and 1-3 hash shards; every aggregate and per-shard row
    as the reference's."""
    rows = _both(lambda pkg: _cell_rows(pkg, cell))
    agg = [r for r in rows if "shard" not in r]
    if cell == "crash":
        assert agg[0]["crash"] and agg[0]["shards"] == 2
    elif cell == "rebalance":
        assert [r["rebalance"] for r in agg] == [False, True]
        assert agg[1]["splits"], "the rebalancer moved a range"
    else:
        assert [r.get("shards", 1) for r in agg] == [1, 2, 3]


def test_sharded_needs_a_card_unless_asked_for_the_cpu():
    """``torch_device="cuda"`` (the default) reaches every shard: without
    a card the cluster refuses to start."""
    sc = port_scenario(tiny_scenario())
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt_cluster.ShardedDB("HHZS", sc, shards=2)
    db = pt_cluster.ShardedDB("HHZS", sc, shards=2, torch_device="cpu")
    assert {s.tree.torch_device.type for s in db.shards} == {"cpu"}
