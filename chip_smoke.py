#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the Bloom-probe kernels from ``src/repro_torch`` with nvcc (into
``build/repro_torch/``), then:

1. kernels vs plain: both CUDA launchers against their plain PyTorch
   versions on the card, bit for bit, on adversarial keys (0, 2**64-1,
   duplicates), random non-members and a ragged multi-filter image;
2. identity: the same seeded YCSB-C cell (a closed-loop per-key probe,
   then an open loop with batched reads) at ``paper_keys // 16`` on
   ``torch_device="cuda"``, on ``torch_device="cpu"`` and on the host's
   numpy route: result rows byte-identical, ``tree.stats`` identical,
   kernels launched on the card only;
3. the real size: scheme HHZS at ``ScenarioConfig().paper_keys`` keys (the
   paper's 200 GiB at 1/SCALE), loaded with ``run_load``.  Two paths run,
   each with the launch counts zeroed just before it and read just after:
   the per-key path, a closed-loop YCSB-C probe that measures the service
   rate (one probe call per read, over all its levels); then the main
   path, YCSB-C open-loop at twice that rate with ``read_batch=64`` for
   at least 100k reads (one probe call per level of a batch).  On each
   path every probe call of the tree must be one kernel launch: calls
   whose pairs all name one SST launch ``bloom_probe``, the others
   ``bloom_probe_pairs``; both kernels must launch on the main path;
4. kernels at the main path's shapes: the probe calls captured in phase 3
   again through kernel, plain version and numpy, compared bit for bit,
   and timed with CUDA events beside the least time the card could take.

Each phase prints one JSON line; the card's name and power limit come
from nvidia-smi.  The last line is ``{"ok": true, "device": {...}}``.  Any
failed check raises, so the exit code is non-zero and no result prints.
Exits non-zero at once when no CUDA card is visible.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels.bloom_probe import bloom_probe as kernel  # noqa: E402
from repro_torch.kernels.bloom_probe import ref  # noqa: E402
from repro_torch.lsm import DB, ScenarioConfig, filters  # noqa: E402
from repro_torch.workloads import (YCSB, PoissonArrivals,  # noqa: E402
                                   run_load, run_open_loop, run_workload)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (guide's table)
CUDA_CORE_OPS_PER_S = 67e12   # H100 SXM non-tensor-core fp32 rate
OPS_PER_PROBE = 8             # mul, add, mod, shift, add, shift, and, test
MAIN_READS = 100_000
FIRST = 16                    # a path's first probe calls, checked
SAMPLE = 64                   # plus a uniform sample, checked and timed
SOURCE = "src/repro_torch/kernels/bloom_probe/csrc/bloom_probe.cu"
REPLACES = {
    "bloom_probe": "src/repro/kernels/bloom_probe/bloom_probe.py:25",
    "bloom_probe_pairs": "src/repro/kernels/bloom_probe/ref.py:49",
}


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def t32(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(a, np.uint32).view(np.int32)).to(dev)


def t64(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# phase 1: kernels vs plain on crafted inputs
# ----------------------------------------------------------------------
def adversarial_keys(rng, n):
    keys = rng.integers(0, 2**63, n).astype(np.uint64)
    keys[0] = np.uint64(0)
    keys[1] = np.uint64(2**64 - 1)
    keys[2] = np.uint64(2**64 - 1)
    keys[3:6] = keys[6]
    return keys


def mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got != want).sum().item())


def phase_kernels(dev) -> dict:
    rng = np.random.default_rng(0)
    out = {}
    for bpk in (4, 10, 16):
        member = adversarial_keys(rng, 4096)
        nw, k = filters.filter_params(len(member), bpk)
        lo, hi = filters.split_hash(member)
        bits = filters.build_filter_np(lo, hi, nw, k)
        built = ref.build_filter(t32(lo, dev), t32(hi, dev), nw, k)
        check(np.array_equal(built.cpu().numpy().view(np.uint32), bits),
              "plain build_filter on the card == numpy builder")
        q = np.concatenate([member[:1024],
                            np.array([0, 2**64 - 1, 1], np.uint64),
                            rng.integers(0, 2**64, 20_000, dtype=np.uint64)])
        qlo, qhi = filters.split_hash(q)
        args = (t32(qlo, dev), t32(qhi, dev), t32(bits, dev))
        got = kernel.bloom_probe(*args, k)
        want = ref.bloom_probe_ref(*args, k)
        host = filters.probe_np(qlo, qhi, bits, k)
        out[f"single_bpk{bpk}"] = {
            "n": len(q), "mismatch_plain": mismatches(got, want),
            "mismatch_numpy": int((got.cpu().numpy().astype(bool)
                                   != host).sum()),
            "no_false_negatives": bool(got[:1024].all().item())}
    # ragged image: filters of different widths, every query x filter
    chunks, offs, nws, cur = [], [], [], 0
    for n in (64, 300, 1000, 10_000, 7):
        keys = rng.integers(0, 2**63, n).astype(np.uint64)
        nw, k = filters.filter_params(n, 10)
        lo, hi = filters.split_hash(keys)
        chunks.append(filters.build_filter_np(lo, hi, nw, k))
        offs.append(cur)
        nws.append(nw)
        cur += nw
    image = np.concatenate(chunks)
    q = adversarial_keys(rng, 5000)
    qlo, qhi = filters.split_hash(q)
    p_lo, p_hi = np.tile(qlo, len(offs)), np.tile(qhi, len(offs))
    p_off = np.repeat(np.array(offs, np.int64), len(q))
    p_nw = np.repeat(np.array(nws, np.int32), len(q))
    args = (t32(p_lo, dev), t32(p_hi, dev), t64(p_off, dev), t32(p_nw, dev),
            t32(image, dev))
    got = kernel.bloom_probe_pairs(*args, k)
    want = ref.bloom_probe_pairs_ref(*args, k)
    host = filters.probe_pairs_np(p_lo, p_hi, p_off, p_nw, image, k)
    out["pairs_ragged"] = {
        "n": len(p_lo), "mismatch_plain": mismatches(got, want),
        "mismatch_numpy": int((got.cpu().numpy().astype(bool)
                               != host).sum())}
    torch.cuda.synchronize()
    for name, r in out.items():
        check(r["mismatch_plain"] == 0 and r["mismatch_numpy"] == 0,
              f"phase 1 {name}: kernel == plain == numpy")
        check(r.get("no_false_negatives", True), f"phase 1 {name}: members")
    return out


# ----------------------------------------------------------------------
# phases 2 and 3: the store
# ----------------------------------------------------------------------
ROUTES = {"cuda": ("torch", "cuda"), "cpu": ("torch", "cpu"),
          "numpy": ("numpy", "cpu")}


def loaded_db(route: str, n_keys: int) -> DB:
    """An HHZS store of ``n_keys`` loaded keys on one probe route: the
    card (``cuda``), the plain PyTorch version (``cpu``) or the host's
    numpy path (``numpy``)."""
    impl, dev = ROUTES[route]
    sc = ScenarioConfig()
    sc = dataclasses.replace(sc, lsm=dataclasses.replace(sc.lsm,
                                                         filter_impl=impl))
    db = DB("HHZS", sc, torch_device=dev)
    run_load(db, n_keys)
    db.flush_all()
    return db


def open_loop(db: DB, n_keys: int, rate: float, n_reads: int):
    """YCSB-C open-loop at ``rate`` with batched reads, for about
    ``n_reads`` arrivals."""
    return run_open_loop(db, YCSB["C"], PoissonArrivals(rate),
                         duration=n_reads / rate, n_keys=n_keys,
                         read_batch=64, seed=1)


def phase_identity(n_keys: int) -> dict:
    rows, stats, launched, wall = {}, {}, {}, {}
    for route in ROUTES:
        kernel.reset_launches()
        t0 = time.perf_counter()
        db = loaded_db(route, n_keys)
        probe = run_workload(db, YCSB["C"], n_ops=2000, n_keys=n_keys)
        res = open_loop(db, n_keys, 2.0 * probe.throughput, 22_000)
        torch.cuda.synchronize()
        wall[route] = time.perf_counter() - t0
        rows[route] = json.dumps([dataclasses.asdict(probe), res.to_json()],
                                 sort_keys=True)
        stats[route] = dict(db.tree.stats)
        launched[route] = dict(kernel.launches)
    out = {"n_keys": n_keys,
           "rows_identical": len(set(rows.values())) == 1,
           "stats_identical": all(v == stats["cuda"] for v in stats.values()),
           "row_bytes": len(rows["cuda"]), "launches": launched,
           "wall_s": wall, "filter_probes": stats["cuda"]["filter_probes"]}
    check(out["rows_identical"],
          "phase 2: cuda, cpu and numpy rows equal, byte for byte")
    check(out["stats_identical"],
          "phase 2: cuda, cpu and numpy tree.stats equal")
    check(all(launched["cuda"][k] > 0 for k in kernel.launches),
          "phase 2: the cuda run launched both kernels")
    check(all(v == 0 for r in ("cpu", "numpy")
              for v in launched[r].values()),
          "phase 2: the cpu and numpy runs launched no kernel")
    return out


class Recorder:
    """Wraps ``filters.probe`` / ``filters.probe_pairs`` (the tree's calls
    into the kernel package) and keeps each call's arguments, as they are:
    the tree builds them afresh for every call and never changes them
    after.  Nothing is computed while the path runs; ``summary`` and
    ``kept`` read the calls afterwards."""

    NAMES = ("bloom_probe", "bloom_probe_pairs")

    def __init__(self):
        self.calls = {n: [] for n in self.NAMES}
        self._orig = (filters.probe, filters.probe_pairs)

    def probe(self, lo, hi, bits, k, impl="torch"):
        self.calls["bloom_probe"].append((lo, hi, bits, k))
        return self._orig[0](lo, hi, bits, k, impl=impl)

    def probe_pairs(self, lo, hi, off, nw, bits, k, impl="torch"):
        self.calls["bloom_probe_pairs"].append((lo, hi, off, nw, bits, k))
        return self._orig[1](lo, hi, off, nw, bits, k, impl=impl)

    def __enter__(self):
        filters.probe, filters.probe_pairs = self.probe, self.probe_pairs
        return self

    def __exit__(self, *exc):
        filters.probe, filters.probe_pairs = self._orig

    def counts(self) -> dict:
        return {n: len(c) for n, c in self.calls.items()}

    def summary(self) -> dict:
        """Probe calls, probes done (pairs) and distinct keys per call."""
        def keys(c):
            return len(np.unique((c[0].astype(np.uint64) << np.uint64(32))
                                 | c[1].astype(np.uint64)))
        every = self.calls["bloom_probe"] + self.calls["bloom_probe_pairs"]
        n = max(1, len(every))
        return {"probe_calls": self.counts(),
                "pairs_probed": sum(len(c[0]) for c in every),
                "mean_pairs_per_call": sum(len(c[0]) for c in every) / n,
                "mean_keys_per_call": sum(keys(c) for c in every) / n,
                "mean_keys_per_call_by_kernel": {
                    name: sum(keys(c) for c in cs) / max(1, len(cs))
                    for name, cs in self.calls.items()}}

    def kept(self, name: str):
        """(sample, first): a seeded uniform sample of ``SAMPLE`` calls,
        and the first ``FIRST`` calls."""
        cs = self.calls[name]
        rng = np.random.default_rng(0)
        pick = sorted(rng.choice(len(cs), min(SAMPLE, len(cs)),
                                 replace=False)) if cs else []
        return [cs[j] for j in pick], cs[:FIRST]


def run_path(db: DB, fn):
    """Run one path with the launch counts zeroed just before it and read
    just after: (result, launches, recorder, wall seconds)."""
    with Recorder() as rec:
        kernel.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = dict(kernel.launches)
    return res, launched, rec, wall


def phase_main(n_keys: int):
    t0 = time.perf_counter()
    db = loaded_db("cuda", n_keys)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    stats = db.tree.stats
    fp0, hits0 = stats["filter_probes"], stats["hits"]
    probe, pk_launched, pk_rec, pk_s = run_path(
        db, lambda: run_workload(db, YCSB["C"], n_ops=2000, n_keys=n_keys))
    fp1, hits1 = stats["filter_probes"], stats["hits"]
    rate = 2.0 * probe.throughput
    res, launched, rec, run_s = run_path(
        db, lambda: open_loop(db, n_keys, rate, int(MAIN_READS * 1.1)))
    row = res.to_json()
    # every level's filter image, as the store holds it now
    images = [db.tree._level_index(lvl)[4]
              for lvl, ssts in enumerate(db.tree.levels) if ssts]
    image_words = sum(len(s.filter_words) for lvl in db.tree.levels
                      for s in lvl)
    resident = sum(t.numel() * 4 for t in images
                   if t.device.type == "cuda")
    perkey = {"reads": probe.n_ops, "wall_s": pk_s,
              "launches": pk_launched, "filter_probes": fp1 - fp0,
              "found": hits1 - hits0, **pk_rec.summary()}
    main = {"reads": row["op_counts"]["read"], "wall_s": run_s,
            "launches": launched,
            "filter_probes": stats["filter_probes"] - fp1,
            "found": stats["hits"] - hits1, **rec.summary()}
    out = {
        "scheme": db.scheme, "n_keys": n_keys,
        "levels": [len(lvl) for lvl in db.tree.levels],
        "filter_words": image_words, "resident_image_bytes": resident,
        "load_s": load_s, "service_rate": probe.throughput,
        "offered_rate": row["offered_rate"],
        "max_queue_depth": row["max_queue_depth"],
        "perkey_path": perkey, "main_path": main,
    }
    for name, path, r in (("per-key", perkey, pk_rec),
                          ("main", main, rec)):
        check(all(n == path["launches"][k] for k, n in r.counts().items()),
              f"phase 3 {name} path: one kernel launch per probe call")
        # YCSB-C reads only loaded keys: a false negative would miss one
        check(path["found"] == path["reads"],
              f"phase 3 {name} path: every read found its key")
    # a per-key read probes all its levels' candidates in one call; a
    # second call only for an SST installed while the read ran
    check(sum(pk_launched.values()) >= probe.n_ops,
          "phase 3 per-key path: one probe call per read")
    check(perkey["pairs_probed"] >= perkey["filter_probes"],
          "phase 3 per-key path: every candidate the walk met was probed "
          "on the card")
    check(main["reads"] >= MAIN_READS, "phase 3: at least 100k reads")
    check(all(v > 0 for v in launched.values()),
          "phase 3: both kernels launched on the main path")
    check(main["pairs_probed"] == main["filter_probes"],
          "phase 3: every Bloom probe of the main path went through a "
          "kernel")
    check(main["mean_keys_per_call"] >= 32,
          "phase 3: at least 32 keys per batched launch")
    check(resident == 4 * image_words,
          "phase 3: every level's filter image is resident on the card")
    check(all(np.isfinite(v) for v in row["latency_p"].values()),
          "phase 3: finite latencies")
    return out, row, rec, pk_rec


# ----------------------------------------------------------------------
# phase 4: the captured main-path calls, again and timed
# ----------------------------------------------------------------------
def touched(lo, hi, off, nw, image, k):
    """(distinct words gathered, probes done) under the kernel's early
    exit at the first clear bit."""
    nbits = nw.astype(np.uint32) * np.uint32(32)
    alive = np.ones(len(lo), bool)
    words, probes = [], 0
    with np.errstate(over="ignore"):
        for i in range(k):
            pos = (lo + np.uint32(i) * hi) % nbits
            widx = off + (pos >> np.uint32(5)).astype(np.int64)
            words.append(widx[alive])
            probes += int(alive.sum())
            bit = (image[widx] >> (pos & np.uint32(31))) & np.uint32(1)
            alive &= bit.astype(bool)
    return np.unique(np.concatenate(words)).size, probes


def cuda_ms(fn, calls, reps):
    for c in calls:
        fn(*c)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for c in calls:
            fn(*c)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


def device_ms(fn, calls, kernel_symbol: str):
    """Mean device time of one launch from ``torch.profiler``'s CUDA
    activity (the kernel alone, without the host's launch path), or None
    when the profiler records no device time for it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for c in calls:
            fn(*c)
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel_symbol in ev.key:
            total_us += getattr(ev, "device_time_total",
                                getattr(ev, "cuda_time_total", 0.0))
            count += ev.count
    return total_us / count / 1e3 if count and total_us > 0 else None


KERNELS = {"bloom_probe": (kernel.bloom_probe, ref.bloom_probe_ref),
           "bloom_probe_pairs": (kernel.bloom_probe_pairs,
                                 ref.bloom_probe_pairs_ref)}


def replay_args(name: str, args):
    """A kept call as (kernel args on the card, the same call as host
    pair arrays (lo, hi, off, nw, image, k), input bytes per item)."""
    if name == "bloom_probe":
        lo, hi, bits, k = args
        dev = bits.device
        off = np.zeros(len(lo), np.int64)
        nw = np.full(len(lo), bits.shape[0], np.int64)
        dargs, in_bytes = (t32(lo, dev), t32(hi, dev), bits), 8
    else:
        # the function needs 4 bytes each of offset and width (the
        # reference's int32 word_off and uint32 num_words); the kernel
        # reads word_off as int64, 4 bytes a pair more than the bound
        lo, hi, off, nw, bits, k = args
        dev = bits.device
        dargs = (t32(lo, dev), t32(hi, dev), t64(off, dev), t32(nw, dev),
                 bits)
        in_bytes = 16
    image = bits.cpu().numpy().view(np.uint32)
    return dargs + (k,), (lo, hi, off, nw, image, k), in_bytes


def phase_captured(rec: Recorder, pk_rec: Recorder, launched: dict,
                   pk_launched: dict) -> list:
    """Every kept call of both paths is checked against the plain version
    and numpy; the main path's sampled calls are also timed, so the times
    and bounds are those of its mix of shapes.  The bound of a call is the
    larger of its bytes (inputs once, the hit mask once, each distinct
    filter word the early-exit probe reads once) over HBM bandwidth and
    its integer operations over the CUDA-core rate."""
    kernels = []
    for name, (fn_k, fn_p) in KERNELS.items():
        calls, t_bytes, t_ops, n_items, worst, mism = [], [], [], 0, 0, 0
        sample, first = rec.kept(name)
        kept = sample + first + [c for part in pk_rec.kept(name)
                                 for c in part]
        for j, args in enumerate(kept):
            dargs, host, in_bytes = replay_args(name, args)
            got, want = fn_k(*dargs), fn_p(*dargs)
            mism += mismatches(got, want)
            mism += int((got.cpu().numpy().astype(bool)
                         != filters.probe_pairs_np(*host)).sum())
            worst = max(worst, int((got - want).abs().max().item()))
            if j < len(sample):
                words, probes = touched(*host)
                n = len(host[0])
                t_bytes.append((n * (in_bytes + 4) + 4 * words)
                               / HBM_BYTES_PER_S)
                t_ops.append(OPS_PER_PROBE * probes / CUDA_CORE_OPS_PER_S)
                n_items += n
                calls.append(dargs)
        check(len(calls) > 0, f"phase 4: {name} calls captured")
        check(mism == 0, f"phase 4: {name} kernel == plain == numpy on "
              "the captured inputs of both paths")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launched[name],
            "launches_per_key_path": pk_launched[name],
            "mismatches": mism, "max_abs_err": worst,
            "ms": cuda_ms(fn_k, calls, 50),
            "plain_ms": cuda_ms(fn_p, calls, 5),
            "bound_ms": 1e3 * float(np.mean(np.maximum(t_bytes, t_ops))),
            "bound_by": ("bytes" if np.mean(t_bytes) >= np.mean(t_ops)
                         else "operations"),
            "library_ms": None,
            "device_ms": device_ms(fn_k, calls, f"{name}_kernel"),
            "checked_calls": len(kept), "timed_calls": len(calls),
            "mean_items_per_call": n_items / len(calls)})
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    lib = kernel.build(force=True)
    kernel.load()
    emit(build={"library": str(lib.relative_to(ROOT)),
                "seconds": time.perf_counter() - t0})
    emit(phase1=phase_kernels(torch.device("cuda")), card=card)
    paper_keys = ScenarioConfig().paper_keys
    emit(phase2=phase_identity(paper_keys // 16), card=card)
    main_out, row, rec, pk_rec = phase_main(paper_keys)
    emit(phase3=main_out, card=card)
    emit(phase3_row=row)
    kernels = phase_captured(rec, pk_rec, main_out["main_path"]["launches"],
                             main_out["perkey_path"]["launches"])
    emit(phase4={"card": card, "kernels": [
        {k: v for k, v in d.items() if k in ("name", "ms", "plain_ms",
                                             "device_ms", "bound_ms",
                                             "timed_calls",
                                             "mean_items_per_call")}
        for d in kernels]})
    emit(kernels=kernels)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
