"""Spans, marks and the device trace of a traced run.

A traced run profiles two stretches of its window, one after the other,
each of the same number of steps:
- the device stretch records only the device's activity (CUPTI), and the
  harness's own marks of what the host is doing (``Marks``: feed, step,
  read), taken from the host clock in the profiler's clock (Unix
  nanoseconds).  It gives the window, the busy time (the union of every
  device interval: kernels, copies, fills), device time by operation and
  the idle gaps, each named by the mark the host was in at the gap's
  middle.  Recording no host operation keeps the profiler's own cost off
  the host, so the idle share is that of an untraced step;
- the host stretch records host ranges as well, with ``Spans`` around
  named program attributes (``"module:Attr.path"``): each call runs in a
  ``record_function`` range ``pb.span:<name>`` and, while recording,
  keeps a description of its arguments (tensors' shapes and dtypes, plain
  values, the plain attributes of other objects such as an autograd
  context).  It gives the device time of what runs inside each span: a
  device operation whose launch call (or, without one, the host range it
  is linked to) falls inside the span, on the thread of that range.  The
  profiler's copies of host ranges on the device's timeline are left out.
"""
from __future__ import annotations

import bisect
import contextlib
import importlib
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

SPAN = "pb.span:"
SIMPLE = (bool, int, float, str, type(None))


def _describe(x):
    if isinstance(x, torch.Tensor):
        return {"shape": tuple(x.shape), "dtype": str(x.dtype).split(".")[-1]}
    if isinstance(x, SIMPLE):
        return x
    if isinstance(x, (tuple, list)) and not hasattr(x, "_fields"):
        return tuple(_describe(v) for v in x)
    if isinstance(x, dict):
        return {"items": len(x)}
    attrs = getattr(x, "__dict__", {})
    return {k: v for k, v in attrs.items() if isinstance(v, SIMPLE)}


class Spans:
    """Wrappers around program attributes, by span name."""

    def __init__(self, targets: Dict[str, str]):
        self.targets = dict(targets)
        self.calls: Dict[str, List[tuple]] = {n: [] for n in targets}
        self.recording = False
        self._undo: List[Tuple[object, str, object]] = []

    @staticmethod
    def _resolve(target: str):
        module, _, path = target.partition(":")
        owner = importlib.import_module(module)
        *parents, attr = path.split(".")
        for p in parents:
            owner = getattr(owner, p)
        return owner, attr

    def install(self) -> None:
        for name, target in self.targets.items():
            owner, attr = self._resolve(target)
            raw = owner.__dict__[attr] if isinstance(owner, type) \
                else getattr(owner, attr)
            static = isinstance(raw, staticmethod)
            fn = raw.__func__ if static else raw
            wrapped = self._wrap(name, fn)
            setattr(owner, attr, staticmethod(wrapped) if static else wrapped)
            self._undo.append((owner, attr, raw))

    def remove(self) -> None:
        while self._undo:
            owner, attr, raw = self._undo.pop()
            setattr(owner, attr, raw)

    def _wrap(self, name: str, fn):
        calls = self.calls

        def wrapper(*args, **kwargs):
            if self.recording:
                calls[name].append((_describe(args), _describe(kwargs)))
            with torch.profiler.record_function(SPAN + name):
                return fn(*args, **kwargs)
        wrapper.__wrapped__ = fn
        return wrapper


@contextlib.contextmanager
def installed(spans: Optional[Spans]):
    if spans is None:
        yield
        return
    spans.install()
    try:
        yield
    finally:
        spans.remove()


class Marks:
    """What the harness is doing, on the host clock (Unix ns), while
    ``on``."""

    def __init__(self):
        self.on = False
        self.log: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def mark(self, name: str):
        if not self.on:
            yield
            return
        t = time.time_ns()
        try:
            yield
        finally:
            self.log.append((name, t, time.time_ns()))


class Event(NamedTuple):
    name: str
    device: bool        # a device operation (else a host range)
    start: int          # ns
    end: int            # ns
    tid: int
    corr: int           # correlation id
    linked: int         # the host range a device operation links to


def events_of(prof) -> List[Event]:
    """The raw events of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() != DeviceType.CPU
        out.append(Event(e.name(), dev, e.start_ns(),
                         e.start_ns() + e.duration_ns(), e.start_thread_id(),
                         e.correlation_id(), e.linked_correlation_id()))
    return out


class Capture:
    """The profiler over one stretch of steps, from a synchronise to a
    synchronise; ``host`` records host ranges too."""

    def __init__(self, device, host: bool):
        self.device = torch.device(device)
        self.host = host
        self.prof = None
        self.t0 = self.t1 = 0
        self.events: Optional[List[Event]] = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] if self.host \
            or self.device.type != "cuda" else []
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.time_ns()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1 = time.time_ns()
        self.prof.__exit__(None, None, None)
        self.events = events_of(self.prof)
        self.prof = None


class Summary(NamedTuple):
    window_s: float
    busy_s: float
    ops: List[Tuple[str, float]]            # device seconds by name
    span_s: Dict[str, float]                # device seconds by span
    gaps: List[Tuple[str, float]]           # idle holes, longest first


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _device_work(events: List[Event]) -> List[Event]:
    """Device operations, without the profiler's copies of host ranges."""
    named = defaultdict(set)
    for e in events:
        if not e.device and e.linked == 0:
            named[e.corr].add(e.name)
    return [e for e in events if e.device
            and not (e.linked == 0 and e.name in named.get(e.corr, ()))]


def device_summary(events: List[Event], w0: int, w1: int,
                   marks: List[Tuple[str, int, int]], top: int = 10):
    """-> (window s, busy s, top operations, top idle gaps) of the
    device stretch [w0, w1]."""
    busy_iv, ops = [], defaultdict(float)
    for e in _device_work(events):
        s, t = max(e.start, w0), min(e.end, w1)
        if t > s:
            busy_iv.append((s, t))
            ops[e.name] += (t - s) / 1e9
    union = _union(busy_iv)
    busy = sum(t - s for s, t in union) / 1e9
    edges = [w0] + [x for iv in union for x in iv] + [w1]
    holes = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
             if edges[i + 1] > edges[i]]
    holes.sort(key=lambda h: h[0] - h[1])
    gaps = []
    for s, t in holes[:top]:
        mid = (s + t) // 2
        inside = [m for m in marks if m[1] <= mid <= m[2]]
        name = max(inside, key=lambda m: m[1])[0] if inside \
            else "outside marks"
        gaps.append((name, (t - s) / 1e9))
    top_ops = sorted(ops.items(), key=lambda o: -o[1])[:top]
    return (w1 - w0) / 1e9, busy, top_ops, gaps


def span_seconds(events: List[Event]) -> Dict[str, float]:
    """Device seconds of what runs inside each ``pb.span:`` range of the
    host stretch."""
    spans: Dict[str, Dict[int, List[Tuple[int, int]]]] = \
        defaultdict(lambda: defaultdict(list))
    for e in events:
        if not e.device and e.name.startswith(SPAN):
            spans[e.name[len(SPAN):]][e.tid].append((e.start, e.end))
    for by_tid in spans.values():
        for lst in by_tid.values():
            lst.sort()
    threads = {t for by_tid in spans.values() for t in by_tid}
    # host ranges on the spans' threads by id; runtime calls (the launch
    # itself, linked to the range it was made in) by correlation id
    host = {e.corr: e for e in events
            if not e.device and e.linked == 0 and e.tid in threads}
    launch = {e.corr: e for e in events if not e.device and e.linked > 0}
    out = {name: 0.0 for name in spans}
    for e in _device_work(events):
        src = host.get(e.linked)
        if src is None:
            continue
        call = launch.get(e.corr)
        at = call.start if call is not None else src.start
        for name, by_tid in spans.items():
            lst = by_tid.get(src.tid)
            if not lst:
                continue
            i = bisect.bisect_right(lst, (at, float("inf"))) - 1
            if i >= 0 and lst[i][0] <= at <= lst[i][1]:
                out[name] += (e.end - e.start) / 1e9
    return out


def summarize(device: Capture, marks: List[Tuple[str, int, int]],
              host: Capture, top: int = 10) -> Summary:
    window, busy, ops, gaps = device_summary(device.events, device.t0,
                                             device.t1, marks, top)
    return Summary(window, busy, ops, span_seconds(host.events), gaps)
