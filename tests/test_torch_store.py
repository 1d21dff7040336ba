"""The port's store held against the JAX package's, op for op.

Same seeded puts, gets, op streams and arrival processes go into a
``repro`` store and a ``repro_torch`` store (``torch_device="cpu"``, asked
for explicitly: here there is no card).  Every answer, every ``tree.stats``
counter, every DES virtual end time and every open-loop result row is an
integer, a boolean or a float computed by the same simulator history, so
every comparison here is exact: equality, and byte equality of the JSON
rows.

The card run of the open-loop comparison, card against CPU, is in
``tests/test_torch_gpu.py``.
"""
import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_scenario  # noqa: E402
from repro import workloads as ref_wl  # noqa: E402
from repro.lsm import DB as RefDB, SCHEMES  # noqa: E402
from repro.lsm import filters as ref_filters  # noqa: E402
from repro.zoned import faults as ref_faults  # noqa: E402
from repro.zoned import sim as ref_sim  # noqa: E402
import repro_torch.lsm as pt_lsm  # noqa: E402
from repro_torch import workloads as pt_wl  # noqa: E402
from repro_torch.lsm import filters  # noqa: E402
from repro_torch.zoned import device as pt_device  # noqa: E402
from repro_torch.zoned import faults as pt_faults  # noqa: E402
from repro_torch.zoned import sim as pt_sim  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _convert(obj, cls, **override):
    kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    kw.update(override)
    return cls(**kw)


def port_scenario(sc, filter_impl="torch"):
    """The port's twin of a reference ``ScenarioConfig``."""
    return _convert(
        sc, pt_lsm.ScenarioConfig,
        lsm=_convert(sc.lsm, pt_lsm.LSMConfig, filter_impl=filter_impl),
        ssd_timing=_convert(sc.ssd_timing, pt_device.DeviceTiming),
        hdd_timing=_convert(sc.hdd_timing, pt_device.DeviceTiming))


def _pair(scheme="HHZS", filter_impl="torch", torch_device="cpu", **kw):
    sc = tiny_scenario(**kw)
    ref = RefDB(scheme, sc, store_values=True)
    port = pt_lsm.DB(scheme, port_scenario(sc, filter_impl),
                     store_values=True, torch_device=torch_device)
    return ref, port


def _fill(dbs, seed=5, n=400, key_space=200):
    rng = np.random.default_rng(seed)
    model = {}
    for i, k in enumerate(rng.integers(0, key_space, size=n)):
        v = b"v%d-%d" % (k, i)
        for db in dbs:
            db.put(int(k), v)
        model[int(k)] = v
    for db in dbs:
        db.drain()
    return model


def _row(res):
    return json.dumps(res.to_json(), sort_keys=True)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("filter_impl", ["torch", "numpy"])
def test_store_matches_reference(filter_impl):
    """Same puts into both stores: batched and per-key answers, stats and
    the virtual clock are identical (mirrors the reference's
    ``test_tree_jax_impl_matches_numpy_impl``)."""
    ref, port = _pair(filter_impl=filter_impl)
    model = _fill([ref, port])
    keys = list(range(0, 250))
    got = port.get_batch(keys)
    assert got == ref.get_batch(keys)
    for key, ans in zip(keys, got):
        assert ans == (key in model, model.get(key))
    assert [port.get(k) for k in keys[::3]] == [ref.get(k) for k in keys[::3]]
    assert port.tree.stats == ref.tree.stats
    assert port.tree.stats["filter_probes"] > 0
    assert port.sim.now == ref.sim.now
    assert port.extras() == ref.extras()


def test_level_images_resident_and_identical():
    """The port keeps each level's filter image as an int32 tensor on its
    torch device, bit-identical to the reference's numpy image, and joins
    them into one store image whose slots are the reference's offsets;
    reference SSTs converted with ``from_reference_sst_arrays`` probe
    identically through a store image of their own."""
    ref, port = _pair()
    _fill([ref, port], n=600, key_space=400)
    rng = np.random.default_rng(1)
    queries = rng.integers(0, 500, 300).astype(np.uint64)
    store = port.tree._store_image()
    prober = filters.Prober()
    checked, base = 0, 0
    for lvl in range(len(ref.tree.levels)):
        if not ref.tree.levels[lvl]:
            continue
        r_ssts, *_, r_bits, r_off = ref.tree._level_index(lvl)
        p_ssts, *_, p_bits, p_off = port.tree._level_index(lvl)
        assert isinstance(p_bits, torch.Tensor)
        assert p_bits.dtype == torch.int32 and p_bits.device.type == "cpu"
        assert np.array_equal(p_bits.numpy().view(np.uint32), r_bits)
        assert p_off == r_off
        for sid, (off, nw) in r_off.items():
            slot = store.slot[sid]
            assert (store.slot_off[slot], store.slot_words[slot]) == \
                (base + off, nw)
        base += len(r_bits)
        conv = [filters.from_reference_sst_arrays(
            s.keys, s.tombs, s.filter_words, s.filter_k, sid=s.sid,
            level=s.level) for s in r_ssts]
        c_bits, c_off = filters.concat_filters(conv)
        assert c_off == r_off and np.array_equal(c_bits, r_bits)
        k = max(s.filter_k for s in conv)
        image = filters.StoreImage(
            [filters.device_words(c_bits, "cpu")],
            [(s.sid, *c_off[s.sid], s.filter_k) for s in conv],
            torch.device("cpu"))
        pair_slot = np.repeat(np.arange(len(conv), dtype=np.int32),
                              len(queries))
        pair_key = np.tile(np.arange(len(queries), dtype=np.int32),
                           len(conv))
        got = prober.probe_pairs(image, queries, pair_key, pair_slot,
                                 np.full(len(pair_key), k, np.uint8))
        lo, hi = filters.split_hash(queries[pair_key])
        off = np.array([c_off[s.sid][0] for s in conv])[pair_slot]
        nw = np.array([c_off[s.sid][1] for s in conv])[pair_slot]
        want = ref_filters.probe_pairs_np(lo, hi, off, nw, r_bits, k)
        assert np.array_equal(got, want)
        checked += 1
    assert checked >= 2, "the fill should populate several levels"
    assert np.array_equal(store.words.numpy().view(np.uint32), np.concatenate(
        [ref.tree._level_index(lvl)[-2] for lvl, ssts in
         enumerate(ref.tree.levels) if ssts]))


@pytest.fixture
def probe_calls(monkeypatch):
    """Counts the calls into the kernel package's two entry points."""
    from repro_torch.kernels.bloom_probe import ops
    calls = {"probe": 0, "probe_pairs": 0}
    for name in calls:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(ops, name, counted)
    return calls


def test_per_key_get_probes_every_level_in_one_call(probe_calls):
    """On the torch route a per-key read probes the candidates of all its
    levels in one call, with answers, stats and clock equal to the
    reference's per-key reads."""
    ref, port = _pair()
    _fill([ref, port], n=600, key_space=400)
    keys = list(range(0, 420, 7))
    levels = [lvl for lvl, ssts in enumerate(port.tree.levels) if ssts]
    assert len(levels) >= 2, "the fill should populate several levels"
    tree = port.tree
    probed = 0
    for key in keys:
        in_memory = any(key in m.data for m in [tree.memtable]
                        + tree.immutables + tree._flushing)
        cands = [s for lvl in levels for s in tree._level_candidates(lvl, key)]
        before = sum(probe_calls.values())
        got = port.get(key)
        assert got == ref.get(key)
        calls = sum(probe_calls.values()) - before
        assert calls == (0 if in_memory or not cands else 1)
        probed += calls
    assert probed > len(keys) // 2 and probe_calls["probe_pairs"] > 0
    assert port.tree.stats == ref.tree.stats
    assert port.sim.now == ref.sim.now


def test_filter_hit_probes_an_sst_the_read_has_not_seen():
    """An SST missing from the read's hits (installed while the read ran)
    is probed when the walk meets it, with the same answer as the scalar
    numpy probe, and kept for the rest of the read."""
    _, port = _pair()
    _fill([port], n=600, key_space=400)
    ssts = [s for lvl in port.tree.levels for s in lvl]
    for key in range(0, 400, 11):
        hits = {}
        for sst in ssts:
            want = filters.probe_one_np(key, sst.filter_words, sst.filter_k)
            assert port.tree._filter_hit(sst, key, hits) == want
            assert hits[sst.sid] == want


def test_one_filter_calls_take_the_single_filter_probe(probe_calls):
    """The per-level call (``_probe_pairs_real``) goes through the
    single-filter entry point when its pairs all name one SST, the pairs
    entry point otherwise; both agree with numpy."""
    _, port = _pair()
    _fill([port], n=600, key_space=400)
    tree = port.tree
    lvl = max(lvl for lvl, ssts in enumerate(tree.levels) if len(ssts) >= 2)
    ssts = tree._level_index(lvl)[0]
    keys = np.arange(0, 64, dtype=np.uint64)
    for pair_ssts, entry in (([ssts[0]] * 64, "probe"),
                             ([ssts[0], ssts[1]] * 32, "probe_pairs")):
        before = dict(probe_calls)
        got = tree._probe_pairs_real(keys, pair_ssts)
        assert probe_calls[entry] == before[entry] + 1
        assert sum(probe_calls.values()) == sum(before.values()) + 1
        want = [filters.probe_one_np(int(k), s.filter_words, s.filter_k)
                for k, s in zip(keys, pair_ssts)]
        assert got.tolist() == want


def test_filterless_ssts_pass_unprobed(probe_calls):
    """SSTs without a filter (built under another mode) pass without a
    probe and take no slot; the filtered pairs of the same call keep their
    hits, and a call whose SSTs are all filterless makes no probe call."""
    _, port = _pair()
    _fill([port], n=600, key_space=400)
    tree = port.tree
    lvl = max(lvl for lvl, ssts in enumerate(tree.levels) if len(ssts) >= 2)
    ssts = tree._level_index(lvl)[0]
    bare = ssts[0]
    bare.filter_words = None
    tree._level_epoch[lvl] += 1
    assert bare.sid not in tree._store_image().slot
    keys = np.arange(0, 64, dtype=np.uint64)
    pair_ssts = [bare, ssts[1]] * 32
    got = tree._probe_slots(keys, np.arange(64, dtype=np.int32), pair_ssts)
    want = [True if s is bare else
            filters.probe_one_np(int(k), s.filter_words, s.filter_k)
            for k, s in zip(keys, pair_ssts)]
    assert got.tolist() == want and not all(want)
    before = sum(probe_calls.values())
    assert tree._probe_slots(keys, np.arange(64, dtype=np.int32),
                             [bare] * 64).all()
    assert tree._probe_pairs_real(keys, [bare] * 64).all()
    assert sum(probe_calls.values()) == before


def _op_sequence(seed, n_ops=300, key_space=250):
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
            ops.append(("scan", key, int(rng.integers(1, 30))))
    return ops


def _run_sequence(db, ops, batch):
    """Run the op sequence; gets go per key (``batch=0``) or through
    ``get_batch`` in groups of ``batch``, flushed before any mutation."""
    out, pending = [], []

    def flush_gets():
        if pending:
            out.extend(zip(pending, db.get_batch(pending)))
            pending.clear()

    for op, key, arg in ops:
        if op == "get":
            if batch:
                pending.append(key)
                if len(pending) >= batch:
                    flush_gets()
            else:
                out.append((key, db.get(key)))
            continue
        flush_gets()
        if op == "put":
            db.put(key, arg)
        elif op == "del":
            db.delete(key)
        else:
            out.append(("scan", db.scan(key, arg)))
    flush_gets()
    db.drain()
    keys = list(range(0, 250, 7))
    out.extend(zip(keys, db.get_batch(keys)))
    return out


@pytest.mark.parametrize("scheme", SCHEMES)
def test_batched_gets_identical_to_per_key(scheme):
    """Per scheme: the port's batched and per-key read paths give the
    reference's answers, and the port's per-key run replays the
    reference's simulator history exactly (mirrors
    ``tests/test_differential.py``)."""
    ops = _op_sequence(seed=0)
    ref, port = _pair(scheme)
    want = _run_sequence(ref, ops, batch=0)
    assert _run_sequence(port, ops, batch=0) == want
    assert port.tree.stats == ref.tree.stats
    assert port.sim.now == ref.sim.now
    _, port_b = _pair(scheme)
    assert _run_sequence(port_b, ops, batch=8) == want


def _in_memory(tree, key):
    return any(key in m.data for m in [tree.memtable] + tree.immutables
               + tree._flushing)


def _count_batches(tree):
    """Wrap ``tree.get_batch`` to count the batches that have a filtered
    candidate pair when they start (the state the batch's one probe call
    sees: it runs before the walk's first yield)."""
    batches = {"calls": 0, "filtered": 0}
    orig = tree.get_batch

    def counted(keys):
        batches["calls"] += 1
        batches["filtered"] += any(
            s.filter_words is not None
            for key in keys if not _in_memory(tree, key)
            for lvl in range(len(tree.levels)) if tree.levels[lvl]
            for s in tree._level_candidates(lvl, key))
        return (yield from orig(keys))

    tree.get_batch = counted
    return batches


def _assert_one_call_per_batch(tree, batches, probe_calls):
    reprobes = tree.probe_calls["reprobe_epoch"] + \
        tree.probe_calls["reprobe_mixed_k"]
    assert batches["filtered"] > 0
    assert tree.probe_calls["batch"] == batches["filtered"]
    assert probe_calls["probe_pairs"] >= batches["filtered"]
    assert sum(probe_calls.values()) == batches["filtered"] + reprobes


@pytest.mark.parametrize("scheme", SCHEMES)
def test_batched_read_makes_one_probe_call(scheme, probe_calls):
    """Per scheme: each batched read with a filtered candidate pair makes
    one pairs call for all its levels (plus the reported re-probes), and
    gives the reference's answers, stats and clock (mirrors
    ``test_batched_gets_identical_to_per_key``)."""
    ops = _op_sequence(seed=0)
    ref, port = _pair(scheme)
    batches = _count_batches(port.tree)
    assert _run_sequence(port, ops, batch=8) == \
        _run_sequence(ref, ops, batch=8)
    assert port.tree.stats == ref.tree.stats
    assert port.sim.now == ref.sim.now
    _assert_one_call_per_batch(port.tree, batches, probe_calls)


@pytest.mark.parametrize("scheme,workload,rate,read_batch", [
    ("HHZS", "C", 60.0, 64), ("B3", "C", 60.0, 64), ("HHZS", "A", 200.0, 16),
    ("B3", "A", 200.0, 16)])
def test_open_loop_one_probe_call_per_batch(scheme, workload, rate,
                                            read_batch, probe_calls):
    """A tiny open-loop cell with batched reads publishes the reference's
    row, byte for byte, with one pairs call per batch that has a filtered
    pair (mirrors ``test_open_loop_row_byte_identical``).
    Under YCSB-A the writes flush and compact while batches wait on I/O:
    levels whose membership moved since the batch's call are probed again
    at walk time, and the row stays the reference's."""
    ref, port, n = _loaded_pair(scheme)
    batches = _count_batches(port.tree)
    rows = []
    for db, wl in ((ref, ref_wl), (port, pt_wl)):
        res = wl.run_open_loop(db, wl.YCSB[workload],
                               wl.PoissonArrivals(rate), duration=40.0,
                               n_keys=n, warmup=5.0, read_batch=read_batch,
                               seed=3)
        rows.append(_row(res))
    assert rows[0] == rows[1]
    assert port.tree.stats == ref.tree.stats
    _assert_one_call_per_batch(port.tree, batches, probe_calls)
    if workload == "A":
        assert port.tree.probe_calls["reprobe_epoch"] > 0


def test_mixed_filter_k_level_takes_the_per_level_call(probe_calls):
    """A level whose SSTs carry filters of different k (images carried
    from reference SSTs with ``from_reference_sst_arrays``) is left out of
    the batch's call and probed at walk time with the reference's
    per-level call (k = the largest of its pending pairs'), with the
    reference's answers, stats and clock."""
    ref, port = _pair()
    _fill([ref, port], n=600, key_space=400)
    lvl = max(lvl for lvl, ssts in enumerate(ref.tree.levels)
              if len(ssts) >= 2)
    for r_sst in ref.tree.levels[lvl][::2]:
        ref_filters.attach_filter(r_sst, 4)        # k 3 beside the level's 7
        conv = filters.from_reference_sst_arrays(
            r_sst.keys, r_sst.tombs, r_sst.filter_words, r_sst.filter_k,
            sid=r_sst.sid, level=r_sst.level)
        p_sst = next(s for s in port.tree.levels[lvl] if s.sid == r_sst.sid)
        p_sst.filter_words, p_sst.filter_k = conv.filter_words, conv.filter_k
    for db in (ref, port):
        db.tree._level_epoch[lvl] += 1           # the filters changed
    assert port.tree._level_index(lvl)[4], "the level mixes filter_k"
    keys = list(range(0, 420, 3))
    for start in range(0, len(keys), 16):
        chunk = keys[start:start + 16]
        assert port.get_batch(chunk) == ref.get_batch(chunk)
    assert port.tree.stats == ref.tree.stats
    assert port.sim.now == ref.sim.now
    assert port.tree.probe_calls["reprobe_mixed_k"] > 0
    assert port.tree.probe_calls["reprobe_epoch"] == 0


# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def sim_speed():
    """``benchmarks/sim_speed.py``'s kernel-parametric workloads."""
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import sim_speed as mod
    finally:
        sys.path.remove(str(ROOT))
    return mod


@pytest.mark.parametrize("bench,args", [
    ("timer_churn", (20_000,)), ("process_chain", (64, 200)),
    ("fifo_device", (32, 400)), ("sem_pool", (6_000, 12)),
    ("daemon_mix", (10_000, 8))])
def test_des_end_times_match_reference(sim_speed, bench, args):
    """The port's DES kernel reaches the reference's virtual end time on
    each ``sim_speed`` shape (scaled down)."""
    fn = getattr(sim_speed, bench)
    end = fn(pt_sim, *args)
    assert end == fn(ref_sim, *args)
    assert end > 0


# ----------------------------------------------------------------------
def _loaded_pair(scheme, n=1200, torch_device="cpu"):
    ref, port = _pair(scheme, torch_device=torch_device)
    for db, wl in ((ref, ref_wl), (port, pt_wl)):
        wl.run_load(db, n_keys=n)
        db.flush_all()
        db.drain()
    return ref, port, n


@pytest.mark.parametrize("scheme,read_batch", [
    ("HHZS", 64), ("B3", 64), ("HHZS", 1)])
def test_open_loop_row_byte_identical(scheme, read_batch):
    """A tiny YCSB-C open-loop cell publishes the reference's row, byte
    for byte; under overload the batched path really batches."""
    ref, port, n = _loaded_pair(scheme)
    rows = []
    for db, wl in ((ref, ref_wl), (port, pt_wl)):
        res = wl.run_open_loop(db, wl.YCSB["C"], wl.PoissonArrivals(60.0),
                               duration=40.0, n_keys=n, warmup=5.0,
                               read_batch=read_batch, seed=3)
        rows.append(_row(res))
    assert rows[0] == rows[1]
    row = json.loads(rows[1])
    assert row["op_counts"]["read"] == row["n_arrived"] > 1000
    assert row["max_queue_depth"] > read_batch
    assert port.tree.stats == ref.tree.stats


def test_open_loop_crash_row_byte_identical():
    """The fault path (crash, WAL replay, reopen onto a fresh tree on the
    same torch device) publishes the reference's row."""
    ref, port, n = _loaded_pair("B3")
    rows = []
    for db, wl, fl in ((ref, ref_wl, ref_faults), (port, pt_wl, pt_faults)):
        spec = fl.FaultSpec(name="crash", crash_at=30.0)
        res = wl.run_open_loop(db, wl.YCSB["A"], wl.PoissonArrivals(10.0),
                               duration=90.0, n_keys=n, warmup=5.0,
                               max_concurrency=8, read_batch=16,
                               faults=spec)
        rows.append(_row(res))
    assert rows[0] == rows[1]
    assert '"crash"' in rows[1]
    assert port.tree.torch_device == torch.device("cpu")


def test_cuda_store_needs_a_card():
    """``torch_device="cuda"`` (the default) never falls back to the CPU:
    without a card the store refuses to start."""
    sc = port_scenario(tiny_scenario())
    if torch.cuda.is_available():
        assert pt_lsm.DB("HHZS", sc).tree.torch_device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            pt_lsm.DB("HHZS", sc)
    numpy_route = port_scenario(tiny_scenario(), filter_impl="numpy")
    assert pt_lsm.DB("HHZS", numpy_route).tree.cfg.filter_impl == "numpy"


# ----------------------------------------------------------------------
def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    """The port, chip_smoke.py and the card's tests import neither JAX nor
    the JAX package, nor ``benchmarks`` (whose linter imports ``repro``),
    in their source or in a fresh interpreter."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu.py",
              ROOT / "tests" / "torch_dist_ranks.py"]
    assert len(files) > 20
    banned = ("jax", "jaxlib", "repro", "benchmarks")
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in banned, (path, name)
    code = ("import sys, repro_torch.workloads, repro_torch.lsm, "
            "repro_torch.serving, repro_torch.models, repro_torch.configs, "
            "repro_torch.data, repro_torch.optim, repro_torch.checkpoint, "
            "repro_torch.ft, repro_torch.launch.train, repro_torch.obs, "
            "repro_torch.cluster, repro_torch.workloads.sweep, "
            "repro_torch.workloads.drift, repro_torch.workloads.serving, "
            "repro_torch.sharding, repro_torch.launch.mesh, "
            "repro_torch.launch.specs, repro_torch.models.moe_sharded, "
            "repro_torch.roofline, repro_torch.launch.dryrun; "
            f"bad = [m for m in sys.modules if m.split('.')[0] in {banned}]; "
            "print(bad); assert not bad")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stdout + r.stderr
