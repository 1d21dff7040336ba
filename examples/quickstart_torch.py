"""Quickstart on the PyTorch/CUDA port: an LSM-tree KV store on simulated
hybrid zoned storage, its Bloom probes on the card.

The port's twin of ``examples/quickstart.py``: the same store, keys and
printed lines.  Creates a small HHZS-managed store (ZNS-SSD + HM-SMR HDD,
paper timing model scaled 1/100), writes and reads KV pairs, runs a skewed
read phase, and prints where data ended up + what the hints did.  Every
per-key read that reaches an SST launches one ``bloom_probe_pairs`` kernel.

  PYTHONPATH=src python examples/quickstart_torch.py                # card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.lsm import DB
from repro_torch.workloads import zipf_probs


def main(argv=None) -> list:
    """Run the quickstart; return the lines it printed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the store's filters are probed (no card: "
                         "raises)")
    args = ap.parse_args(argv)
    lines = []

    def say(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    db = DB("HHZS", store_values=True, torch_device=args.device)
    say(f"scheme={db.scheme}  ssd zones={len(db.ssd.zones)} "
        f"(x{db.ssd.zone_capacity >> 20} MiB)  "
        f"hdd zones={len(db.hdd.zones)}")

    n = 30_000
    say(f"loading {n} KV objects ...")
    rng = np.random.default_rng(0)
    for k in rng.permutation(n):
        db.put(int(k), value=b"value-%d" % k)
    db.flush_all()

    found, val = db.get(1234)
    if not (found and val == b"value-1234"):
        raise RuntimeError(f"get(1234) gave {found}, {val!r}")
    db.delete(1234)
    if db.get(1234)[0]:
        raise RuntimeError("get(1234) found the deleted key")
    say("point reads + delete OK; scanning [5000, 5030) ...")
    db.scan(5000, 30)

    say("skewed read phase (zipf a=1.1) ...")
    p = zipf_probs(n, 1.1)
    keys = rng.permutation(n)[rng.choice(n, size=4000, p=p)]
    for k in keys:
        db.get(int(k))
    db.drain()

    t = db.tree
    be = db.backend
    lvl = [f"L{i}={s/1e6:.1f}MB" for i, s in enumerate(t.level_sizes()[:5])]
    say(f"levels: {' '.join(lvl)}")
    say(f"flushes={t.stats['flushes']:.0f} "
        f"compactions={t.stats['compactions']:.0f} "
        f"bloom_fps={t.stats['bloom_fp']:.0f}")
    ssd_lv = {}
    for s in be.ssd_ssts():
        ssd_lv[s.level] = ssd_lv.get(s.level, 0) + 1
    say(f"SSD SSTs by level: {dict(sorted(ssd_lv.items()))}  "
        f"(tiering level {be.placement.tiering_level()})")
    if be.cache:
        say(f"hinted cache: admitted={be.cache.admitted} "
            f"hits={be.cache.hits}")
    if be.migrator:
        m = be.migrator
        say(f"migration: popularity={m.popularity_moves} "
            f"capacity={m.capacity_moves} "
            f"bytes={m.bytes_moved/1e6:.1f}MB")
    say(f"virtual time: {db.sim.now:.1f}s")
    return lines


if __name__ == "__main__":
    main()
