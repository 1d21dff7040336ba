"""YCSB head-to-head on the PyTorch/CUDA port: HHZS vs the best basic
scheme vs SpanDB-AUTO, every read's Bloom probes on the card.

The port's twin of ``examples/ycsb_demo.py``: the same stores, workloads
and printed lines (every figure is simulated, so the card's lines equal
the CPU's).  A reduced version of Exp#1 (paper Fig.5): fresh load per
scheme, then workloads A and C.  Expect HHZS highest throughput, with the
gap widest on read-heavy workloads (migration + hinted cache).

Then an *open-loop* burst scenario: the same stores face on-off Poisson
arrivals whose burst rate exceeds the service rate.  Closed-loop clients
can never see this regime — the open-loop runner decomposes the resulting
tail latency into queueing delay vs service time per scheme.

Finally a *multi-tenant* flash-crowd scenario: a protected steady tenant
shares one store with a flash-crowd tenant, and the admission controller
is switched from `none` to `reject` — watch the protected tenant's p999
queueing delay collapse while the crowd is shed.

  PYTHONPATH=src python examples/ycsb_demo_torch.py           # full demo
  PYTHONPATH=src python examples/ycsb_demo_torch.py --quick   # CI sizing
  PYTHONPATH=src python examples/ycsb_demo_torch.py --quick --device cpu
"""
import argparse

from repro_torch.core.middleware import AdmissionConfig
from repro_torch.lsm import DB, ScenarioConfig
from repro_torch.workloads import (BurstyArrivals, FlashCrowdArrivals,
                                   PoissonArrivals, TenantSpec, YCSB,
                                   run_load, run_multi_tenant, run_open_loop,
                                   run_workload)


def _fresh(scheme, n, device):
    db = DB(scheme, torch_device=device)
    load = run_load(db, n_keys=n)
    db.flush_all()
    return db, load


def main(argv=None) -> list:
    """Run the demo; return the lines it printed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="CI smoke sizing (same code paths, reduced "
                         "dataset/runs)")
    ap.add_argument("--device", default="cuda",
                    help="where the stores' filters are probed (no card: "
                         "raises)")
    args = ap.parse_args(argv)
    lines = []

    def say(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    quick, device = args.quick, args.device
    div, n_ops = (64, 800) if quick else (4, 4000)
    n = ScenarioConfig().paper_keys // div
    results = {}
    for scheme in ["B3", "AUTO", "HHZS"]:
        db, load = _fresh(scheme, n, device)
        row = {"load": load.throughput}
        for wl in ["A", "C"]:
            r = run_workload(db, YCSB[wl], n_ops=n_ops, n_keys=n)
            row[wl] = r.throughput
        results[scheme] = row
        say(f"{scheme:5s} load={row['load']:8.1f}  "
            f"A={row['A']:6.2f}  C={row['C']:6.2f}  (sim OPS)")
    for wl in ["A", "C"]:
        gain = results["HHZS"][wl] / results["B3"][wl] - 1
        say(f"HHZS vs B3 on {wl}: {gain*100:+.0f}%")

    # ---- open-loop burst scenario ------------------------------------
    # bursts at 3x the weakest scheme's closed-loop service rate, base at
    # 0.3x: queues build during the minute-long burst and drain (or not)
    # during the off phase
    svc = min(results[s]["A"] for s in results)
    arrival = BurstyArrivals(base_rate=0.3 * svc, burst_rate=3.0 * svc,
                             on=60.0, off=240.0)
    burst_dur = 300.0 if quick else 1200.0
    say(f"\nopen-loop burst ({arrival.name}, "
        f"virtual {burst_dur/60:.0f} min):")
    for scheme in ["B3", "HHZS"]:
        db, _ = _fresh(scheme, n, device)
        res = run_open_loop(db, YCSB["A"], arrival, duration=burst_dur,
                            n_keys=n, warmup=60.0)
        say(res.row())

    # ---- multi-tenant flash crowd + admission control ----------------
    # a protected steady tenant and a flash-crowd tenant share one HHZS
    # store; shedding off (none) vs on (reject-at-pressure)
    mt_dur = 300.0 if quick else 900.0
    tenants = [
        TenantSpec("steady", YCSB["A"], PoissonArrivals(0.3 * svc),
                   protected=True),
        TenantSpec("crowd", YCSB["A"],
                   FlashCrowdArrivals(0.1 * svc, 4.0 * svc,
                                      at=mt_dur / 5, decay=mt_dur / 6)),
    ]
    say(f"\nmulti-tenant flash crowd (virtual {mt_dur/60:.0f} min, "
        f"steady tenant protected):")
    p999 = {}
    for policy in ["none", "reject"]:
        db, _ = _fresh("HHZS", n, device)
        res = run_multi_tenant(
            db, tenants, duration=mt_dur, n_keys=n, warmup=30.0,
            max_concurrency=16,
            policy=AdmissionConfig(policy=policy, queue_threshold=32))
        steady = res.by_tenant("steady")
        crowd = res.by_tenant("crowd")
        p999[policy] = steady.queue_p["p999"]
        say(f"  policy={policy:6s} steady p999 queue "
            f"{steady.queue_p['p999']*1e3:9.1f}ms  "
            f"(crowd shed={int(crowd.admission['rejected'])}"
            f"/{crowd.n_arrived})")
    if p999["reject"] > 0:
        ratio = p999["none"] / p999["reject"]
        if ratio >= 1.05:
            say(f"  shedding cuts the protected tenant's p999 queueing "
                f"delay {ratio:.1f}x")
        else:
            say(f"  shedding did not improve the protected tenant's "
                f"p999 queueing delay here ({ratio:.2f}x)")
    elif p999["none"] > 0:
        say("  shedding eliminates the protected tenant's p999 "
            "queueing delay entirely")
    return lines


if __name__ == "__main__":
    main()
