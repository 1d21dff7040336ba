"""Parallel, resumable, deterministic sweep driver over ScenarioMatrix cells.

``ScenarioMatrix`` declares a grid of (scheme x workload x arrival x
SSD-budget) cells; this module actually *runs* the grid at scale:

* **Sharding.**  Cells are distributed across worker processes.  Every cell
  is self-contained — a freshly loaded store, seeded arrival/op streams —
  so the rows are **identical for any worker count** (asserted by
  ``tests/test_torch_control.py``): workers only change wall-clock time, never
  results.  The output file lists rows in canonical cell order (the order
  ``ScenarioMatrix.cells()`` enumerates), not completion order.
* **Resume.**  Rows already present in the output file are kept and their
  cells skipped (``resume=True``), so an interrupted sweep continues where
  it stopped; the file is rewritten atomically after every completed cell.
  Rows whose cell is *not* part of the running matrix (multi-tenant rows,
  fault rows, other sweeps) are always preserved untouched — the
  merge-never-overwrite invariant of ``results/storage/scenarios.json``.
* **Selection.**  ``cells=`` takes either index ranges (``"0,3,7-9"``) or
  an ``fnmatch`` pattern against cell names (``"HHZS/*/z20"``);
  ``budget_s=`` stops dispatching new cells once the wall-clock budget is
  spent (completed cells are kept — rerun to continue).

CLI (the full-grid reproduction sweep)::

  PYTHONPATH=src python -m repro_torch.workloads.sweep \
      --workers 2 --out results/storage/scenarios.json
  PYTHONPATH=src python -m repro_torch.workloads.sweep \
      --schemes B3,HHZS --workloads A,B --arrivals poisson \
      --key-div 16 --duration 300 --cells 'HHZS/*' --budget-s 600

The default grid is all 10 schemes x YCSB A-F x {poisson, bursty, ramp}
x 2 SSD budgets; offered rates are calibrated once from a seeded
closed-loop probe (deterministic, so resumed runs regenerate identical
cell names).
"""
from __future__ import annotations

import argparse
import fnmatch
import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Union

from .runner import (BurstyArrivals, PoissonArrivals, RampArrivals,
                     ScenarioMatrix)
from .ycsb import YCSB, WorkloadSpec, run_load, run_workload


@dataclass(frozen=True)
class GridDBFactory:
    """Picklable store factory for sweep cells (workers must rebuild it).

    Mirrors the methodology of ``benchmarks/storage_exps.py``: fresh store,
    load ``paper_keys // (load_div * key_div)`` objects, drain the WAL, run
    while the compaction backlog is live.  Every store it builds (each
    shard of a sharded one) probes its filters on ``torch_device``.
    """

    key_div: int = 1
    load_div: int = 4
    rebalance_period: float = 30.0
    torch_device: str = "cuda"

    def __call__(self, scheme: str, ssd_zones: int,
                 filter_bits: Optional[int] = None, shards: int = 1,
                 routing: str = "hash", rebalance: bool = False):
        from dataclasses import replace
        from ..lsm import DB, ScenarioConfig
        sc = ScenarioConfig(ssd_zones=ssd_zones)
        if filter_bits is not None:     # the matrix's filter-bits axis
            sc = replace(sc, lsm=replace(
                sc.lsm, filter_bits_per_key=int(filter_bits)))
        n = sc.paper_keys // (self.load_div * self.key_div)
        if shards > 1:                  # the matrix's sharding axis
            from ..cluster import ShardedDB
            db = ShardedDB(scheme, sc, shards=shards, routing=routing,
                           key_space=n, rebalance=rebalance,
                           rebalance_period=self.rebalance_period,
                           torch_device=self.torch_device)
        else:
            db = DB(scheme, sc, torch_device=self.torch_device)
        run_load(db, n_keys=n)
        db.flush_all()
        db.n_keys = n
        return db


def _run_cell(matrix: ScenarioMatrix, idx: int):
    """Worker entry: run cell ``idx`` of the (pickled) matrix."""
    cell = matrix.cells()[idx]
    _, rows = matrix.run_cell(cell)
    return idx, rows


def parse_cell_selector(spec: Optional[str]) -> Callable[[int, str], bool]:
    """Build a (index, cell-name) predicate from a ``--cells`` argument.

    ``None``/empty selects everything; a string of digits, commas and
    dashes selects index ranges (``"0,3,7-9"``); anything else is an
    ``fnmatch`` pattern against the cell name (``"HHZS/*/z20"``).
    """
    if not spec:
        return lambda i, name: True
    if all(c.isdigit() or c in ",- " for c in spec):
        picked = set()
        for part in spec.replace(" ", "").split(","):
            if not part:
                continue
            if "-" in part:
                lo, hi = part.split("-", 1)
                picked.update(range(int(lo), int(hi) + 1))
            else:
                picked.add(int(part))
        return lambda i, name: i in picked
    return lambda i, name: fnmatch.fnmatch(name, spec)


def _atomic_write(path: Path, rows: List[Dict]) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(json.dumps(rows, indent=1))
    os.replace(tmp, path)


def run_sweep(matrix: ScenarioMatrix,
              out: Optional[Union[str, Path]] = None,
              *,
              workers: int = 0,
              cells: Optional[str] = None,
              budget_s: Optional[float] = None,
              resume: bool = True,
              verbose: bool = True,
              validate: Optional[Callable[[List[Dict]], None]] = None
              ) -> List[Dict]:
    """Run (the selected part of) a ScenarioMatrix, sharded over workers.

    Returns the matrix's rows in canonical cell order (resumed rows
    included).  With ``out``, the file is updated atomically after every
    completed cell: foreign rows first (file order), then matrix rows in
    canonical order.  ``workers=0`` runs inline (no process pool) —
    row-identical to any ``workers>=1`` run by construction, since cells
    share no state.  ``validate`` (if given) is called on the merged row
    list before every write and must raise on schema violations.
    """
    all_cells = matrix.cells()
    names = [c.name for c in all_cells]
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"matrix has duplicate cell names: {dupes[:3]}")
    name_set = set(names)

    existing: List[Dict] = []
    out_path = Path(out) if out is not None else None
    if out_path is not None and out_path.exists():
        existing = json.loads(out_path.read_text())
    foreign = [r for r in existing if r.get("cell") not in name_set]
    # previously published rows for this matrix's cells: with resume they
    # make the cell skippable; without (--fresh) the cell re-runs but its
    # old rows are kept until the replacement lands — selecting a subset
    # or interrupting a fresh run must never drop published results
    done: Dict[str, List[Dict]] = {}
    for r in existing:
        cell = r.get("cell")
        if cell in name_set:
            done.setdefault(cell, []).append(r)

    selected = parse_cell_selector(cells)
    pending = [i for i, c in enumerate(all_cells)
               if selected(i, c.name)
               and (not resume or c.name not in done)]
    if verbose and resume and done:
        print(f"[sweep] resume: {len(done)} cells already in {out_path}, "
              f"{len(pending)} to run", flush=True)

    fresh: Dict[int, List[Dict]] = {}
    deadline = None if budget_s is None else time.monotonic() + budget_s

    def merged() -> List[Dict]:
        rows: List[Dict] = []
        for i, c in enumerate(all_cells):
            if i in fresh:                    # this run's result wins
                rows.extend(fresh[i])
            elif c.name in done:              # kept (resumed or not rerun)
                rows.extend(done[c.name])
        return rows

    def checkpoint() -> None:
        if out_path is None:
            return
        rows = foreign + merged()
        if validate is not None:
            validate(rows)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        _atomic_write(out_path, rows)

    def note(idx: int, rows: List[Dict]) -> None:
        fresh[idx] = rows
        checkpoint()
        if verbose:
            for r in rows:
                if "shard" in r:        # per-shard sub-rows: no latency
                    continue
                # serving rows carry decode_p where storage rows carry
                # latency_p — the note line is kind-agnostic
                lat = r.get("latency_p") or r.get("decode_p") or {}
                print(f"[sweep {idx + 1}/{len(all_cells)}] {r['cell']:<48s} "
                      f"thpt={r['throughput']:8.1f}/s "
                      f"p99={lat.get('p99', 0) * 1e3:9.2f}ms",
                      flush=True)

    skipped_budget = 0
    if workers <= 0:
        for idx in pending:
            if deadline is not None and time.monotonic() > deadline:
                skipped_budget = len(pending) - len(fresh)
                break
            note(*_run_cell(matrix, idx))
    else:
        # workers are spawned, never forked: a forked child of a process
        # that has started CUDA cannot use the card, and torch's thread
        # pools do not survive a fork either; spawn costs each worker its
        # imports, and rows do not depend on the start method
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
            in_flight = {}
            it = iter(pending)
            stop = False

            def submit_next() -> bool:
                nonlocal stop
                if stop:
                    return False
                if deadline is not None and time.monotonic() > deadline:
                    stop = True
                    return False
                idx = next(it, None)
                if idx is None:
                    return False
                in_flight[pool.submit(_run_cell, matrix, idx)] = idx
                return True

            for _ in range(2 * workers):
                if not submit_next():
                    break
            while in_flight:
                ready, _ = wait(list(in_flight), return_when=FIRST_COMPLETED)
                for fut in ready:
                    del in_flight[fut]
                    note(*fut.result())
                    submit_next()
        skipped_budget = len(pending) - len(fresh)

    if skipped_budget and verbose:
        print(f"[sweep] wall-clock budget spent: {skipped_budget} selected "
              f"cells not run (resume with the same command)", flush=True)
    checkpoint()
    return merged()


# ======================================================================
# the default full-grid sweep (CLI)
# ======================================================================
ARRIVAL_KINDS = ("poisson", "bursty", "ramp")


def arrivals_for_rate(kinds: Sequence[str], svc: float) -> List:
    """The sweep's arrival shapes, anchored to one service rate ``svc``:
    base Poisson at 0.5x (stable), bursty 0.2x->3x (overloads during
    bursts, drains in the off phase), ramp 0.1x->1.5x (crosses saturation
    mid-run)."""
    table = {
        "poisson": PoissonArrivals(round(0.5 * svc, 4)),
        "bursty": BurstyArrivals(round(0.2 * svc, 4), round(3.0 * svc, 4),
                                 on=60.0, off=240.0),
        "ramp": RampArrivals(round(0.1 * svc, 4), round(1.5 * svc, 4)),
    }
    unknown = [k for k in kinds if k not in table]
    if unknown:
        raise ValueError(f"unknown arrival kinds {unknown}; "
                         f"one of {sorted(table)}")
    return [table[k] for k in kinds]


def calibrated_arrivals(kinds: Sequence[str], workloads: Sequence[str],
                        *, key_div: int, load_div: int = 4,
                        ssd_zones: int = 20, seed: int = 1,
                        verbose: bool = False,
                        torch_device: str = "cuda") -> Dict[str, List]:
    """Per-workload offered rates from seeded closed-loop probes of the
    weakest baseline (B3), as in ``benchmarks/storage_exps.py`` — but per
    YCSB workload, because service rates differ by an order of magnitude
    across the mix (scan-heavy E serves ~15x slower than read-heavy C;
    one global rate would leave half the grid permanently overloaded).
    Probes are deterministic, so resumed sweeps regenerate identical rates
    — and therefore identical cell names."""
    factory = GridDBFactory(key_div=key_div, load_div=load_div,
                            torch_device=torch_device)
    out: Dict[str, List] = {}
    for w in workloads:
        probe = factory("B3", ssd_zones)
        spec = YCSB[w] if isinstance(w, str) else w
        pr = run_workload(probe, spec, n_ops=2000, n_keys=probe.n_keys,
                          seed=seed)
        svc = max(pr.throughput, 1e-6)
        out[spec.name] = arrivals_for_rate(kinds, svc)
        if verbose:
            print(f"[sweep] probe {spec.name}: service ~{svc:.1f} ops/s",
                  flush=True)
    return out


def build_grid(schemes: Sequence[str], workloads: Sequence[str],
               arrival_kinds: Sequence[str], budgets: Sequence[int],
               *, duration: float, warmup: float, key_div: int,
               seed: int = 1, verbose: bool = False,
               timelines: Optional[str] = None,
               shards: Sequence[int] = (1,), routing: str = "hash",
               rebalance: Sequence[bool] = (False,),
               torch_device: str = "cuda") -> ScenarioMatrix:
    """The full-grid ScenarioMatrix the CLI (and CI smoke/nightly) runs.

    ``timelines`` enables the per-cell telemetry bus (``repro_torch.obs``) and
    dumps one timeline artifact per cell into that directory — telemetry
    is pull-only, so the published rows stay byte-identical with it on
    (asserted by the CI grid-smoke telemetry leg).
    """
    arrivals = calibrated_arrivals(arrival_kinds, workloads,
                                   key_div=key_div, ssd_zones=min(budgets),
                                   seed=seed, verbose=verbose,
                                   torch_device=torch_device)
    return ScenarioMatrix(
        schemes=list(schemes), workloads=list(workloads),
        arrivals=arrivals, ssd_zone_budgets=list(budgets),
        duration=duration, warmup=warmup, key_div=key_div, seed=seed,
        db_factory=GridDBFactory(key_div=key_div, torch_device=torch_device),
        telemetry=timelines is not None, timeline_dir=timelines,
        shards=list(shards), routing=routing, rebalance=list(rebalance),
        torch_device=torch_device)


def build_control_grid(schemes: Sequence[str], *, duration: float,
                       warmup: float, key_div: int, seed: int = 1,
                       verbose: bool = False,
                       timelines: Optional[str] = None,
                       torch_device: str = "cuda") -> ScenarioMatrix:
    """A small multi-tenant control-plane matrix (CLI ``--control``).

    One protected + one bulk tenant under the full-knob feedback policy
    (PI controller driving admission, compaction pacing, migration
    aggressiveness and the hinted-cache reservation) — the same
    construction as ``benchmarks/storage_exps.py::bench_control`` at
    smoke sizing.  The CI grid-smoke job runs this grid twice (2 workers
    vs inline, telemetry on) and requires byte-identical rows: the
    control plane is a sim process, so its ticks — and every knob write
    they make — are part of the deterministic event schedule.
    """
    from repro_torch.core.middleware import AdmissionConfig
    from repro_torch.lsm import SCALE
    from repro_torch.zoned.device import MiB

    from .runner import TenantSpec
    from .ycsb import WorkloadSpec

    factory = GridDBFactory(key_div=key_div, torch_device=torch_device)
    spec = WorkloadSpec("mix", read=0.5, update=0.5, alpha=0.9)
    bspec = WorkloadSpec("bulkmix", read=0.5, update=0.5, alpha=0.9)
    # anchor rates/SLOs to a seeded closed-loop probe of the weakest
    # baseline, exactly as calibrated_arrivals() does for the YCSB grid
    probe = factory("B3", 20)
    pr = run_workload(probe, spec, n_ops=2000, n_keys=probe.n_keys,
                      seed=seed)
    svc = max(pr.throughput, 1e-6)
    slo_prot = round(1.5 * pr.latency_p["p99"], 4)
    debt_th = round(1.5 * float(probe.tree.compaction_debt())
                    + 256 * MiB / SCALE, 1)
    bulk_rate = round(1.2 * svc, 4)
    if verbose:
        print(f"[sweep] control probe: service ~{svc:.1f} ops/s, "
              f"prot slo {slo_prot * 1e3:.1f}ms", flush=True)
    mix = [
        TenantSpec("prot", spec, PoissonArrivals(round(0.25 * svc, 4)),
                   protected=True, slo_p99=slo_prot),
        TenantSpec("bulk", bspec, PoissonArrivals(bulk_rate),
                   slo_p99=round(1.5 * slo_prot, 4)),
    ]
    policy = AdmissionConfig(
        policy="feedback", bucket_rates={"bulk": (bulk_rate, 20.0)},
        debt_threshold=debt_th, label="pi+knobs", queue_threshold=8,
        feedback_interval=2.5, feedback_window=60,
        feedback_controller="pi", feedback_kp=2.0, feedback_ki=0.5,
        feedback_smooth=1.0, feedback_rise=0.08,
        feedback_knobs=("admission", "compaction", "migration", "cache"))
    return ScenarioMatrix(
        schemes=list(schemes), workloads=[], arrivals=[], tenants=[mix],
        policies=[policy], ssd_zone_budgets=[20],
        duration=duration, warmup=warmup, max_concurrency=16,
        key_div=key_div, seed=seed, db_factory=factory,
        telemetry=timelines is not None, timeline_dir=timelines,
        torch_device=torch_device)


def build_drift_grid(schemes: Sequence[str], programs: Sequence[str],
                     arrival_kinds: Sequence[str], *, phase_s: float,
                     warmup: float, key_div: int, seed: int = 1,
                     verbose: bool = False,
                     timelines: Optional[str] = None,
                     budgets: Sequence[int] = (20,),
                     torch_device: str = "cuda") -> ScenarioMatrix:
    """The drift scenario grid (CLI ``--drift``): named
    ``TraceProgram``\\ s (``repro_torch.workloads.drift``) x schemes x arrival
    kinds x SSD budgets.  Offered rates are anchored to one seeded
    closed-loop probe of the weakest baseline (B3) on a 50/50 mix, as in
    ``build_control_grid`` — deterministic, so resumed sweeps regenerate
    identical programs and cell names.  Each cell runs the program's own
    virtual-time schedule and emits per-tenant rows with
    ``drift``/``phases`` columns; with ``timelines`` the telemetry bus
    additionally records phase-boundary marks (pull-only: rows are
    byte-identical either way, asserted by the CI grid-smoke drift leg).
    """
    from .drift import build_program

    factory = GridDBFactory(key_div=key_div, torch_device=torch_device)
    probe = factory("B3", min(budgets))
    spec = WorkloadSpec("mix", read=0.5, update=0.5, alpha=0.9)
    pr = run_workload(probe, spec, n_ops=2000, n_keys=probe.n_keys,
                      seed=seed)
    svc = max(pr.throughput, 1e-6)
    if verbose:
        print(f"[sweep] drift probe: service ~{svc:.1f} ops/s", flush=True)
    progs = [build_program(name, svc=round(svc, 4), n_keys=probe.n_keys,
                           arrival_kind=kind, phase_s=phase_s)
             for name in programs for kind in arrival_kinds]
    return ScenarioMatrix(
        schemes=list(schemes), workloads=[], arrivals=[],
        ssd_zone_budgets=list(budgets), warmup=warmup,
        key_div=key_div, seed=seed, db_factory=factory,
        telemetry=timelines is not None, timeline_dir=timelines,
        drift_programs=progs, torch_device=torch_device)


def main(argv: Optional[List[str]] = None) -> int:
    from repro_torch.lsm.db import SCHEMES
    ap = argparse.ArgumentParser(
        description="full-grid scenario sweep (parallel, resumable)")
    ap.add_argument("--schemes", default=",".join(SCHEMES),
                    help="comma-separated placement schemes")
    ap.add_argument("--workloads", default="A,B,C,D,E,F",
                    help="comma-separated YCSB workload letters")
    ap.add_argument("--arrivals", default="poisson,bursty,ramp",
                    help="comma-separated arrival kinds "
                         "(poisson, bursty, ramp)")
    ap.add_argument("--budgets", default="20,40",
                    help="comma-separated SSD zone budgets")
    ap.add_argument("--duration", type=float, default=600.0,
                    help="virtual seconds of arrivals per cell")
    ap.add_argument("--warmup", type=float, default=60.0)
    ap.add_argument("--key-div", type=int, default=16,
                    help="dataset divisor (1 = paper-scale dataset)")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--workers", type=int, default=0,
                    help="worker processes (0 = run inline)")
    ap.add_argument("--cells", default=None,
                    help="cell selector: index ranges '0,3,7-9' or an "
                         "fnmatch pattern like 'HHZS/*/z20'")
    ap.add_argument("--budget-s", type=float, default=None,
                    help="wall-clock budget; stop dispatching new cells "
                         "after this many seconds")
    ap.add_argument("--shards", default="1",
                    help="comma-separated shard counts; entries > 1 run "
                         "the cell on a ShardedDB (repro_torch.cluster)")
    ap.add_argument("--routing", default="hash",
                    choices=("hash", "range"),
                    help="router for sharded cells")
    ap.add_argument("--rebalance", action="store_true",
                    help="also sweep the online rebalancer on sharded "
                         "cells (adds the -rb variant; range routing)")
    ap.add_argument("--out", default="results/storage/scenarios.json")
    ap.add_argument("--fresh", action="store_true",
                    help="re-run cells even if already present in --out")
    ap.add_argument("--timelines", default=None, metavar="DIR",
                    help="enable per-cell telemetry (repro_torch.obs) and "
                         "write one timeline artifact per cell into DIR; rows "
                         "are unchanged")
    ap.add_argument("--control", action="store_true",
                    help="run the small multi-tenant control-plane grid "
                         "(prot+bulk tenants, full-knob PI feedback "
                         "policy) instead of the YCSB grid; honours "
                         "--schemes/--duration/--warmup/--key-div")
    ap.add_argument("--drift", default=None, metavar="PROGRAMS",
                    help="run the drift grid instead of the YCSB grid: "
                         "comma-separated TraceProgram names "
                         "(repro_torch.workloads.drift, e.g. 'rotate,churn'); "
                         "honours --schemes/--arrivals (poisson, bursty)/"
                         "--budgets/--warmup/--key-div/--phase-s")
    ap.add_argument("--phase-s", type=float, default=150.0,
                    help="virtual seconds per drift-program phase")
    ap.add_argument("--torch-device", default="cuda",
                    help="where the stores probe their Bloom filters "
                         "('cuda' or 'cpu')")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.drift:
        matrix = build_drift_grid(
            [s for s in args.schemes.split(",") if s],
            [p for p in args.drift.split(",") if p],
            [a for a in args.arrivals.split(",") if a
             and a in ("poisson", "bursty")] or ["poisson"],
            phase_s=args.phase_s, warmup=args.warmup,
            key_div=args.key_div, seed=args.seed,
            verbose=not args.quiet, timelines=args.timelines,
            budgets=[int(b) for b in args.budgets.split(",") if b],
            torch_device=args.torch_device)
    elif args.control:
        matrix = build_control_grid(
            [s for s in args.schemes.split(",") if s],
            duration=args.duration, warmup=args.warmup,
            key_div=args.key_div, seed=args.seed,
            verbose=not args.quiet, timelines=args.timelines,
            torch_device=args.torch_device)
    else:
        matrix = build_grid(
            [s for s in args.schemes.split(",") if s],
            [w for w in args.workloads.split(",") if w],
            [a for a in args.arrivals.split(",") if a],
            [int(b) for b in args.budgets.split(",") if b],
            duration=args.duration, warmup=args.warmup,
            key_div=args.key_div, seed=args.seed,
            timelines=args.timelines,
            shards=[int(s) for s in args.shards.split(",") if s],
            routing=args.routing,
            rebalance=[False, True] if args.rebalance else [False],
            torch_device=args.torch_device)

    t0 = time.time()
    rows = run_sweep(matrix, out=args.out, workers=args.workers,
                     cells=args.cells, budget_s=args.budget_s,
                     resume=not args.fresh, verbose=not args.quiet)
    n_cells = len({r["cell"] for r in rows})
    print(f"[sweep] {n_cells}/{len(matrix.cells())} cells "
          f"({len(rows)} rows) in {args.out} "
          f"[{time.time() - t0:.0f}s wall]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
