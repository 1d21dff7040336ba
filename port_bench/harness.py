"""One run of one cell: the manifest and the files it names, set-up, the
measured window, the check against the reference, the traced metrics
and the result's line.

Everything that belongs to one configuration, traffic mix, cell or
metric is found by name (``Bench``), so a cell, a mix or a metric is
added as files:
- ``BENCHMARK.json`` names the cell's configuration, traffic mix and
  metrics;
- ``configs/<config>.json``: the configuration's sizes (the manifest
  gives the path);
- ``traffic/<mix>.json``: the mix's parameters, with the ``driver`` that
  runs it, ``traffic/<driver>.py``;
- ``workloads/<cell>.json``: the cell's limits on the numbers its check
  compares;
- ``metrics/<metric>.py`` (or ``metrics/<part before the first
  dot>.py``): a reader with ``read(run, summary, name)`` and the program
  attributes it wants spans around, ``SPANS``.

A driver has ``setup(run)``, ``window(run, state)`` and ``check(run,
state)``; see ``README.md``.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import devtrace

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level modules that no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


class BenchError(RuntimeError):
    """A cell that cannot run as its files describe it."""


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise BenchError(f"no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """The manifest at ``root`` and the benchmark's files under
    ``root/<bench_dir>``."""

    def __init__(self, root: Path = ROOT, bench_dir: str = BENCH_DIR.name):
        self.root = Path(root)
        self.dir = self.root / bench_dir
        self.manifest = load_json(self.root / "BENCHMARK.json")

    def _entry(self, key: str, name: str) -> Dict:
        for e in self.manifest[key]:
            if e["name"] == name:
                return e
        raise BenchError(f"no {key} entry named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> Dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> Dict:
        return load_json(self.root / self._entry("configs", name)["file"])

    def traffic(self, name: str) -> Dict:
        return load_json(self.dir / "traffic" / f"{name}.json")

    def cell(self, name: str) -> Dict:
        return load_json(self.dir / "workloads" / f"{name}.json")

    def driver(self, kind: str):
        return load_module(self.dir / "traffic" / f"{kind}.py",
                           f"port_bench_driver_{kind}")

    def reader(self, metric: str):
        for stem in (metric, metric.split(".")[0]):
            path = self.dir / "metrics" / f"{stem}.py"
            if path.is_file():
                return load_module(path, "port_bench_metric_"
                                   + stem.replace(".", "_"))
        raise BenchError(f"no reader for metric {metric!r} under "
                         f"{self.dir / 'metrics'}")

    def end_to_end(self, cell: str) -> List[Dict]:
        """The end-to-end metrics ``cell`` reports."""
        return [m for m in self.manifest["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[Dict]:
        """The per-layer metrics ``cell`` reports: those listing it, and
        those with no list that move an end-to-end metric it reports."""
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.manifest["per_layer"]
                if cell in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in moved)]


def program_config(cfg: Dict):
    """The port's ``ModelConfig`` for the benchmark's configuration."""
    from repro_torch.config import ModelConfig
    pcfg = ModelConfig(
        name=cfg["name"], family=cfg["family"],
        num_layers=cfg["num_layers"], d_model=cfg["d_model"],
        num_heads=cfg["num_heads"], num_kv_heads=cfg["num_kv_heads"],
        d_ff=cfg["d_ff"], vocab_size=cfg["vocab_size"],
        head_dim=cfg["head_dim"], sliding_window=cfg["sliding_window"],
        full_attn_layers=tuple(cfg["full_attn_layers"]),
        rope_theta=cfg["rope_theta"], ssm_state=cfg["ssm_state"],
        ssm_conv=cfg["ssm_conv"], d_inner=cfg["d_inner"],
        norm_eps=cfg["norm_eps"], act=cfg["act"],
        tie_embeddings=cfg["tie_embeddings"], source=cfg["source"])
    if pcfg.has_ssm and pcfg.dt_rank != cfg["dt_rank"]:
        raise BenchError(f"the port's dt_rank {pcfg.dt_rank} is not the "
                         f"configuration's {cfg['dt_rank']}")
    return pcfg


class Run:
    """One run of one cell: what the driver and the readers see."""

    def __init__(self, bench: Bench, workload: str, seed: int,
                 seconds: float, trace: bool, device,
                 faults: Tuple[str, ...] = ()):
        self.bench, self.name = bench, workload
        self.entry = bench.workload(workload)
        self.cfg = bench.config(self.entry["config"])
        self.mix = bench.traffic(self.entry["traffic"])
        self.cell = bench.cell(workload)
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.device = torch.device(device)
        self.faults = frozenset(faults)
        self.marks = devtrace.Marks()
        self.summary: Optional[devtrace.Summary] = None
        self.traced: Dict[str, float] = {}      # work of the traced steps
        self.readers: Dict[str, object] = {}
        targets: Dict[str, str] = {}
        if trace:
            for m in bench.per_layer(workload):
                reader = bench.reader(m["name"])
                self.readers[m["name"]] = reader
                targets.update(getattr(reader, "SPANS", {}))
        self.spans = devtrace.Spans(targets) if targets else None

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def program_config(self):
        return program_config(self.cfg)

    def free(self) -> None:
        """Return the program's freed memory before the reference runs."""
        import gc
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def phase(self, name: str):
        """A mark of what the harness is doing (feed, step, read)."""
        return self.marks.mark(name)

    def closed_loop(self, body: Callable[[int], None], trace_steps: int
                    ) -> Tuple[float, List[float]]:
        """``body(i)`` for i = 0, 1, ... (each call ends in a read on the
        host) until ``seconds`` have passed at the end of a call.  In a
        traced run the first ``trace_steps`` calls run under the device
        stretch of the profiler and the next ``trace_steps`` under its
        host stretch, with the spans recording (``devtrace``); the loop
        runs at least that many.  -> (the window's start, each call's
        end), host clock."""
        stretches = [devtrace.Capture(self.device, False),
                     devtrace.Capture(self.device, True)] \
            if self.trace else []
        done: List[devtrace.Capture] = []
        ends: List[float] = []
        t0 = time.perf_counter()
        i = 0
        while True:
            if stretches and i == len(done) * trace_steps:
                stretches[0].start()
                self.marks.on = not stretches[0].host
                if self.spans is not None:
                    self.spans.recording = stretches[0].host
            body(i)
            i += 1
            t = time.perf_counter()
            ends.append(t)
            if stretches and i == (len(done) + 1) * trace_steps:
                cap = stretches.pop(0)
                cap.stop()
                self.marks.on = False
                if self.spans is not None:
                    self.spans.recording = False
                done.append(cap)
                if not stretches:
                    self.summary = devtrace.summarize(
                        done[0], self.marks.log, done[1])
            if t - t0 >= self.seconds and not stretches:
                return t0, ends


def forbidden_modules() -> List[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def device_info(run: Run, peak: int) -> Dict:
    if run.cuda:
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(run.device),
                "count": run.entry["chips"], "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """Each number against its limit (a number at or under its limit
    passes; one that is not finite fails)."""
    if set(numbers) != set(limits):
        raise BenchError(f"the check compares {sorted(numbers)}, the cell "
                         f"limits {sorted(limits)}")
    checks = {n: {"value": float(numbers[n]), "limit": float(limits[n])}
              for n in sorted(numbers)}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def execute(run: Run, t_start: float) -> Dict:
    """Set-up, window, check and, in a traced run, the per-layer metrics
    -> the result's line (a dict, ``checks`` last)."""
    driver = run.bench.driver(run.mix["driver"])
    with devtrace.installed(run.spans):
        state = driver.setup(run)
        run.sync()
        setup_s = time.perf_counter() - t_start
        out = driver.window(run, state)
        run.sync()
        peak = torch.cuda.max_memory_allocated(run.device) if run.cuda else 0
    numbers = driver.check(run, state)
    correct, checks = judge(numbers, run.cell["checks"])
    line = {"correct": correct, "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": {},
            "device": device_info(run, peak)}
    if run.trace:
        summary = run.summary
        for m in run.bench.per_layer(run.name):
            value = run.readers[m["name"]].read(run, summary, m["name"])
            if value is not None:
                line["metrics"][m["name"]] = {"value": float(value),
                                              "unit": m["unit"]}
        line["device"]["busy_s"] = summary.busy_s
        line["device"]["window_s"] = summary.window_s
        line["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in summary.ops],
            "idle_gaps": [[n, s] for n, s in summary.gaps]}
    else:
        values = dict(out["metrics"], setup_s=setup_s)
        for m in run.bench.end_to_end(run.name):
            if m["name"] not in values:
                raise BenchError(f"the {run.mix['driver']} driver gave no "
                                 f"{m['name']}")
            line["metrics"][m["name"]] = {"value": float(values[m["name"]]),
                                          "unit": m["unit"]}
    line["checks"] = checks
    return line
