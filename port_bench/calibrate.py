"""The readings that the limits of ``workloads/<cell>.json`` are set
from: for each seed, the numbers the cell's check compares for the
program and for the control (the reference in float8 in the program's
place), and for each planted fault the program run with that fault.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds <window> [--control] [--faults half_batch,...] \
        [--out chiprun_out/calib.jsonl]

Runs on the machine it is started on, in one process, a cell at its own
size: set-up, a window of ``--seconds`` (a training cell's check needs
none; a serving cell's needs as many steps as a run's), the check.  One
JSON line a reading (``workload``, ``seed``, ``reading``, ``numbers``,
``seconds``) to standard output and to ``--out``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).parent:
    sys.path.pop(0)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def readings(bench, workload, seed, seconds, device, control, faults):
    from port_bench import harness
    out = []
    for fault in [None] + list(faults):
        t = time.perf_counter()
        run = harness.Run(bench, workload, seed, seconds, False, device,
                          () if fault is None else (fault,))
        driver = bench.driver(run.mix["driver"])
        st = driver.setup(run)
        driver.window(run, st)
        numbers = driver.check(run, st)
        out.append({"workload": workload, "seed": seed,
                    "reading": fault or "program", "numbers": numbers,
                    "seconds": time.perf_counter() - t})
        if fault is None and control:
            t = time.perf_counter()
            out.append({"workload": workload, "seed": seed,
                        "reading": "control_fp8",
                        "numbers": driver.control(run, st),
                        "seconds": time.perf_counter() - t})
        del st
        run.free()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from port_bench import harness
    bench = harness.Bench(ROOT)
    faults = [f for f in args.faults.split(",") if f]
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            for rec in readings(bench, args.workload, seed, args.seconds,
                                args.device, args.control, faults):
                line = json.dumps(rec)
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
