#!/usr/bin/env python3
"""Host cost of the port's read paths on each Bloom-probe route.

    python3 tools/route_cost.py [--src DIR] [--keys N] [--ops N]

Loads two identical HHZS stores of ``--keys`` keys (default
``ScenarioConfig().paper_keys // 16``): one probes on the CUDA card
(``filter_impl="torch"``, ``torch_device="cuda"``), the other on the host
(``filter_impl="numpy"``).  Both then run the same YCSB-C segments:

* per-key: closed-loop ``run_workload`` of ``--ops`` reads (read_batch 1);
* batched: ``run_open_loop`` with ``read_batch=64`` and Poisson arrivals
  at twice the per-key segments' service rate, for about ``10 * --ops``
  reads (the overload keeps batches full, as in ``chip_smoke.py``).

Each kind runs as four segments in the order numpy, cuda, cuda, numpy, so
that drift of the host's clock falls on both routes alike.  The stores
see the same op streams, so their results and ``tree.stats`` must be
identical (checked); the difference in wall time is the probe route's.

The probe stage is the tree's probe calls (``LSMTree._probe_slots`` and
``_probe_pairs_real``, whichever the version has; a call inside another
counts once): each is timed with ``time.perf_counter`` and summed.  On
the numpy route a per-key read probes inside its walk
(``_filter_hit``), outside the stage.

Prints the card's name and power limit, then one JSON line: per path
kind and route, wall seconds of each segment, microseconds per read, the
probe stage's microseconds per read and share of the wall time, and per
read the probe calls, kernel launches and Bloom probes.  ``--src`` names
the ``src`` directory to import ``repro_torch`` from (default: this
checkout's), so two versions of the port can be timed in one run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--keys", type=int, default=0,
                    help="store size (default paper_keys // 16)")
    ap.add_argument("--ops", type=int, default=5000,
                    help="reads per per-key segment")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch

    from repro_torch.kernels.bloom_probe import bloom_probe as kernel
    from repro_torch.lsm import DB, ScenarioConfig
    from repro_torch.lsm.tree import LSMTree
    from repro_torch.workloads import (YCSB, PoissonArrivals, run_load,
                                       run_open_loop, run_workload)

    if not torch.cuda.is_available():
        print("route_cost: no CUDA card visible", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kernel.load()
    n_keys = args.keys or ScenarioConfig().paper_keys // 16

    stage = {"n": 0, "s": 0.0, "depth": 0}
    orig = {name: getattr(LSMTree, name) for name in
            ("_probe_slots", "_probe_pairs_real") if hasattr(LSMTree, name)}

    def timed(fn):
        def wrap(*a, **kw):
            if stage["depth"]:
                return fn(*a, **kw)
            stage["depth"] = 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                stage["s"] += time.perf_counter() - t0
                stage["n"] += 1
                stage["depth"] = 0
        return wrap

    dbs = {}
    for route, impl, dev in (("numpy", "numpy", "cpu"),
                             ("cuda", "torch", "cuda")):
        sc = ScenarioConfig()
        sc = dataclasses.replace(
            sc, lsm=dataclasses.replace(sc.lsm, filter_impl=impl))
        db = DB("HHZS", sc, torch_device=dev)
        run_load(db, n_keys)
        db.flush_all()
        dbs[route] = db

    def perkey(db, seed):
        res = run_workload(db, YCSB["C"], n_ops=args.ops, n_keys=n_keys,
                           seed=seed)
        return res.op_counts["read"], dataclasses.asdict(res), res.throughput

    rate = {}

    def batched(db, seed):
        res = run_open_loop(db, YCSB["C"], PoissonArrivals(rate["r"]),
                            duration=10 * args.ops / rate["r"],
                            n_keys=n_keys, read_batch=64, seed=seed)
        row = res.to_json()
        return row["op_counts"]["read"], row, None

    out = {"src": str(Path(args.src)), "n_keys": n_keys, "card": card}
    rows = {"numpy": [], "cuda": []}
    for name, fn in orig.items():
        setattr(LSMTree, name, timed(fn))
    try:
        for kind, fn in (("perkey", perkey), ("batched", batched)):
            seconds = {"numpy": [], "cuda": []}
            per = {r: {"probe_calls": 0, "launches": 0, "filter_probes": 0,
                       "reads": 0} for r in dbs}
            probe_s = {"numpy": [], "cuda": []}
            for route, seed in (("numpy", 1), ("cuda", 1), ("cuda", 2),
                                ("numpy", 2)):
                db = dbs[route]
                kernel.reset_launches()
                stage.update(n=0, s=0.0)
                fp0 = db.tree.stats["filter_probes"]
                t0 = time.perf_counter()
                reads, row, thpt = fn(db, seed)
                torch.cuda.synchronize()
                seconds[route].append(time.perf_counter() - t0)
                probe_s[route].append(stage["s"])
                if thpt is not None:
                    rate.setdefault("r", 2.0 * thpt)
                p = per[route]
                p["probe_calls"] += stage["n"]
                p["launches"] += sum(kernel.launches.values())
                p["filter_probes"] += db.tree.stats["filter_probes"] - fp0
                p["reads"] += reads
                rows[route].append(json.dumps(row, sort_keys=True))
            out[kind] = {
                "seconds": seconds,
                "us_per_read": {r: 1e6 * sum(s) / per[r]["reads"]
                                for r, s in seconds.items()},
                "probe_seconds": probe_s,
                "probe_us_per_read": {r: 1e6 * sum(s) / per[r]["reads"]
                                      for r, s in probe_s.items()},
                "probe_share": {r: sum(probe_s[r]) / sum(seconds[r])
                                for r in seconds},
                "reads": per["cuda"]["reads"],
                "per_read": {r: {k: v / p["reads"] for k, v in p.items()
                                 if k != "reads"} for r, p in per.items()}}
            if per["cuda"]["launches"] == 0 or per["numpy"]["launches"]:
                print(f"route_cost: {kind}: the cuda route launched no "
                      "kernel, or the numpy route launched one",
                      file=sys.stderr)
                return 1
    finally:
        for name, fn in orig.items():
            setattr(LSMTree, name, fn)
    out["levels"] = [len(lvl) for lvl in dbs["cuda"].tree.levels]
    out["results_identical"] = (
        rows["numpy"] == rows["cuda"]
        and dbs["numpy"].tree.stats == dbs["cuda"].tree.stats)
    print(json.dumps({"route_cost": out}), flush=True)
    if not out["results_identical"]:
        print("route_cost: the two routes' results differ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
