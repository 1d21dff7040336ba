"""Run one cell of the port's benchmark once and print its result.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the port (``src/repro_torch``).  The last line of standard output is
the result (JSON); the last lines of standard error are the numbers the
check compared, each beside its limit.  Exits with 2, printing no
result, without a CUDA card (or with fewer cards than the cell asks
for) or without the port; with 3 if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).parent:
    sys.path.pop(0)             # this folder's modules are port_bench.*
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"port_bench: no src/repro_torch under {ROOT}: nothing to "
              "measure", file=sys.stderr)
        return 2
    import torch
    from port_bench import harness
    bench = harness.Bench(ROOT)
    chips = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: {args.workload} needs {chips} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    run = harness.Run(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0")
    line = harness.execute(run, T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"port_bench: the run loaded {', '.join(found)}: no result",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
