"""Virtual-time metrics registry: the telemetry bus of the reproduction.

The HHZS thesis is that the middleware should act on *signals* from the
LSM-tree and the devices (§3.1 flush / compaction / caching hints); this
module makes every such signal a first-class, queryable time series:

* **Counters** — push-style monotonic accumulators (``c.add(n)``) for the
  rare signal with no existing state to pull from.  One attribute add on
  the hot path; nothing else.
* **Gauges** — *pull* callbacks evaluated only at sample time.  Every
  built-in instrumentation point (device queue depth, zone occupancy,
  compaction debt, WAL pressure, admission counters) is a gauge or a
  collector over state the layers already maintain, so an instrumented
  run executes the exact same hot-path code as an uninstrumented one —
  which is what keeps the ``sim_speed`` gate and the sweep driver's
  byte-identical-rows contract intact with telemetry enabled.
* **Collectors** — gauges with dynamic key sets (per-tenant admission
  counters: tenants appear lazily).  A collector returns a ``{name:
  value}`` dict per sample; with ``rate=True`` the registry stores the
  per-second delta between consecutive samples of each key instead of
  the raw (monotonic) value — the windowed-rate primitive.
* **Series** — every sampled signal lands in a bounded ring buffer
  (capacity ``capacity`` samples, oldest overwritten) keyed to a shared
  ring of sample times, taken every ``sample_period`` *virtual* seconds
  by a daemon process (daemon: sampling never keeps ``Sim.run()`` alive
  and never perturbs the virtual times of real events).

``timeline()`` serializes the rings as the timeline artifact schema
(``results/storage/timelines/*.json``, linted by
``benchmarks/validate_results.py``)::

    {"kind": "timeline", "meta": {...}, "sample_period": 5.0,
     "t": [t0, t1, ...], "series": {"lsm.debt": [v0, v1, ...], ...}}

Series entries are numbers or ``null`` (signal not yet registered at that
sample, e.g. a tenant that had not arrived).
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

TIMELINE_KIND = "timeline"


class Counter:
    """Push-style monotonic counter; ``add()`` is the whole hot-path cost."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def add(self, n: float = 1.0) -> None:
        self.value += n


class Ewma:
    """Exponentially-weighted moving average over irregular updates.

    The control plane's measurement filter: per-tick p99/target ratios are
    noisy (a window of a few hundred samples), and feeding them raw into a
    PI law turns measurement noise into actuator jitter.  ``update(x)``
    folds in one observation with weight ``alpha`` (1.0 = no smoothing —
    the filter is transparent) and returns the new smoothed value;
    ``value`` holds the current estimate (``None`` before any update)."""

    __slots__ = ("alpha", "value")

    def __init__(self, alpha: float = 0.5) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1]: {alpha}")
        self.alpha = float(alpha)
        self.value: Optional[float] = None

    def update(self, x: float) -> float:
        x = float(x)
        if self.value is None or self.alpha >= 1.0:
            self.value = x
        else:
            self.value += self.alpha * (x - self.value)
        return self.value

    def reset(self) -> None:
        self.value = None


class MetricsRegistry:
    """Bounded ring-buffer time series over DES-clock samples.

    Attach with ``DB.enable_telemetry()`` (which calls every layer's
    ``install_metrics``) or register signals directly; ``start()`` spawns
    the daemon sampler.  ``restart()`` revives sampling after a
    ``DB.crash()`` killed the sampler process along with everything else.
    """

    def __init__(self, sim, sample_period: float = 5.0,
                 capacity: int = 720):
        if sample_period <= 0:
            raise ValueError(f"sample_period must be > 0: {sample_period}")
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0: {capacity}")
        self.sim = sim
        self.sample_period = float(sample_period)
        self.capacity = int(capacity)
        self.counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Callable[[], float]] = {}
        # name -> (fn, rate): named collectors can be rebound (e.g. a new
        # per-run AdmissionController re-installing its tenant counters)
        self._collectors: Dict[str, Tuple[Callable[[], Dict[str, float]],
                                          bool]] = {}
        self._anon = 0
        # shared ring: _t holds sample times; every series list is kept
        # exactly as long as _t (None-padded when registered late)
        self._t: List[float] = []
        self._series: Dict[str, List[Optional[float]]] = {}
        self._head = 0              # next overwrite slot once the ring is full
        # previous raw values of rate-collector keys: (value, sample time)
        self._prev: Dict[str, Tuple[float, float]] = {}
        self.samples = 0
        self._gen = 0               # sampler generation (restart() bumps it)
        self._running = False
        # point-in-time annotations (e.g. drift phase boundaries): pure
        # list appends off the sampling path, never a DES event
        self._marks: List[Tuple[float, str]] = []

    # -- registration ---------------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str, fn: Callable[[], float]) -> None:
        """Register (or rebind — e.g. after ``DB.reopen()`` swaps the tree)
        a pull gauge; evaluated only at sample time."""
        self._gauges[name] = fn

    def collector(self, fn: Callable[[], Dict[str, float]],
                  rate: bool = False, name: Optional[str] = None) -> None:
        """Register a dynamic-key gauge.  With ``rate=True`` each key's
        series holds the per-second delta between consecutive samples
        (windowed rate of a monotonic count), not the raw value.  A
        ``name`` makes the registration rebindable — a second call with
        the same name replaces the first (fresh per-run controllers)."""
        if name is None:
            self._anon += 1
            name = f"_anon{self._anon}"
        self._collectors[name] = (fn, rate)

    def aggregate_gauge(self, name: str, part_names: List[str],
                        reduce: str = "sum") -> None:
        """Register a gauge computed from other *registered gauges* at
        sample time — the cluster-rollup primitive (repro_torch.cluster):
        e.g.
        ``cluster.lsm.debt = sum(s0.lsm.debt, s1.lsm.debt, ...)``.

        Parts are looked up by name on every sample, so a shard reopen
        that rebinds ``s{i}.lsm.*`` to a recovered tree is picked up
        automatically; parts not (yet) registered are skipped.  ``reduce``
        is ``"sum"``, ``"max"`` or ``"mean"``."""
        if reduce not in ("sum", "max", "mean"):
            raise ValueError(f"unknown reduce {reduce!r}; "
                             f"one of ('sum', 'max', 'mean')")
        parts = list(part_names)

        def _agg() -> float:
            vals = [float(self._gauges[p]())
                    for p in parts if p in self._gauges]
            if not vals:
                return 0.0
            if reduce == "sum":
                return float(sum(vals))
            if reduce == "max":
                return float(max(vals))
            return float(sum(vals) / len(vals))

        self.gauge(name, _agg)

    def attach_dict(self, d: Dict[str, float], prefix: str = "",
                    rate: bool = False,
                    name: Optional[str] = None) -> None:
        """Register a plain counter dict (e.g. a manager's ``stats``) as a
        collector: each key becomes a ``prefix + key`` series, sampled by
        reference so later mutations are visible.  With ``rate=True`` the
        series hold windowed per-second deltas (monotonic counters)."""
        self.collector(
            lambda: {prefix + k: float(v) for k, v in d.items()},
            rate=rate, name=name)

    # -- sampling -------------------------------------------------------
    def _store(self, values: Dict[str, float], now: float) -> None:
        n = len(self._t)
        if n < self.capacity:
            self._t.append(now)
            for name, vs in self._series.items():
                vs.append(values.pop(name, None))
            for name, v in values.items():     # newly-seen series
                self._series[name] = [None] * n + [v]
        else:
            i = self._head
            self._head = (i + 1) % self.capacity
            self._t[i] = now
            for name, vs in self._series.items():
                vs[i] = values.pop(name, None)
            for name, v in values.items():
                vs = self._series[name] = [None] * self.capacity
                vs[i] = v

    def sample_now(self) -> None:
        """Take one sample of every registered signal at ``sim.now``."""
        now = self.sim.now
        values: Dict[str, float] = {}
        for name, c in self.counters.items():
            values[name] = c.value
        for name, fn in self._gauges.items():
            values[name] = float(fn())
        for fn, rate in self._collectors.values():
            for name, v in fn().items():
                v = float(v)
                if rate:
                    prev = self._prev.get(name)
                    self._prev[name] = (v, now)
                    if prev is None or now <= prev[1]:
                        values[name] = 0.0
                    else:
                        values[name] = (v - prev[0]) / (now - prev[1])
                else:
                    values[name] = v
        self._store(values, now)
        self.samples += 1

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._gen += 1
        self.sim.process(self._sampler(self._gen))

    def restart(self) -> None:
        """Revive sampling after ``DB.crash()`` killed the sampler process
        (bumping the generation retires any survivor from a spurious call)."""
        self._running = False
        self.start()

    def stop(self) -> None:
        self._running = False
        self._gen += 1          # any live sampler loop retires on next tick

    def _sampler(self, gen: int):
        while self._gen == gen:
            yield self.sim.timeout(self.sample_period, daemon=True)
            if self._gen != gen:
                return
            self.sample_now()

    # -- queries --------------------------------------------------------
    def _unrolled(self, vs: List) -> List:
        if len(self._t) < self.capacity:
            return list(vs)
        h = self._head
        return vs[h:] + vs[:h]

    def times(self) -> List[float]:
        return self._unrolled(self._t)

    def series(self, name: str) -> List[Optional[float]]:
        return self._unrolled(self._series.get(name, []))

    def latest(self, name: str) -> Optional[float]:
        vs = self._series.get(name)
        if not vs:
            return None
        i = (self._head - 1) % len(self._t) if len(self._t) >= self.capacity \
            else len(self._t) - 1
        return vs[i]

    def names(self) -> List[str]:
        return sorted(self._series)

    # -- marks ----------------------------------------------------------
    def mark(self, label: str, t: Optional[float] = None) -> None:
        """Record a point-in-time annotation (``t`` defaults to
        ``sim.now``) — e.g. a drift-trace phase boundary.  Marks are not
        a series: they land in the timeline artifact's ``marks`` list so
        plots can segment the run without resampling anything."""
        self._marks.append((float(self.sim.now if t is None else t),
                            str(label)))

    def marks(self) -> List[Tuple[float, str]]:
        return list(self._marks)

    # -- timeline artifact ----------------------------------------------
    @staticmethod
    def _clean(v: Optional[float]) -> Optional[float]:
        if v is None or not math.isfinite(v):
            return None
        return v

    def timeline(self, meta: Optional[Dict[str, Any]] = None) -> Dict:
        """JSON-ready timeline artifact (see the module docstring schema).
        When any :meth:`mark` was recorded the artifact additionally
        carries ``"marks": [{"t": ..., "label": ...}, ...]`` (ascending
        ``t``) — phase-boundary annotations for segmented plots."""
        out = {
            "kind": TIMELINE_KIND,
            "meta": dict(meta or {}),
            "sample_period": self.sample_period,
            "t": self.times(),
            "series": {name: [self._clean(v) for v in self.series(name)]
                       for name in self.names()},
        }
        if self._marks:
            out["marks"] = [{"t": t, "label": lbl}
                            for t, lbl in sorted(self._marks)]
        return out

    def dump_timeline(self, path: Union[str, Path],
                      meta: Optional[Dict[str, Any]] = None) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.timeline(meta), indent=1))
        return path


def timeline_path(out_dir: Union[str, Path], cell_name: str) -> Path:
    """Filesystem-safe artifact path for a cell's timeline (cell names
    contain ``/``)."""
    safe = cell_name.replace("/", "__").replace(" ", "")
    return Path(out_dir) / f"{safe}.json"
