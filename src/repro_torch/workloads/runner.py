"""Open-loop workload engine + declarative scenario matrix.

The paper evaluates HHZS only with closed-loop YCSB clients (ycsb.py):
offered load self-throttles to the store's service rate, so queueing never
builds up and the flush/compaction/migration interference shows only in
service time.  Production KV stores face *open-loop* arrivals — requests
keep coming whether or not the store keeps up — where the same interference
surfaces as queueing delay and tail-latency blowup.

This module holds:

* Arrival processes: ``PoissonArrivals`` (memoryless), ``BurstyArrivals``
  (on-off modulated Poisson: bursts over a base rate), ``RampArrivals``
  (linearly ramping rate — a single diurnal load edge), ``DiurnalArrivals``
  (piecewise-linear multi-ramp through a list of rate knots — a full
  day-shaped profile), ``FlashCrowdArrivals`` (steady base rate with a
  sudden spike that decays exponentially — news-event traffic), all
  generating arrival timestamps in virtual seconds from a seeded RNG.
* ``run_open_loop``: arrivals enqueue ops; a bounded server pool (modelling
  the store's request threads) services the queue.  Per-op accounting
  splits total latency into *queueing delay* (arrival -> service start)
  and *service time* (start -> completion), with a warm-up window excluded
  from statistics and a virtual-time limit on the arrival stream.  With
  ``read_batch > 1`` queued point reads are served through
  ``LSMTree.get_batch``, whose Bloom probes run on the store's torch
  device.
* ``run_multi_tenant``: N named tenants (``TenantSpec``), each with its own
  workload, arrival process, and seeded op stream, share one ``DB`` and one
  bounded server pool.  The same queueing/service decomposition is reported
  *per tenant*, and each arrival passes through the store's admission
  controller (``repro_torch.core.middleware.AdmissionController``) so
  shedding / delaying policies can protect an SLO tenant from a
  misbehaving neighbour.
* ``ScenarioMatrix``: sweeps (scheme x workload x arrival x SSD-zone
  budget) — or, in multi-tenant mode, (scheme x tenant-mix x admission
  policy x SSD-zone budget) — from a declarative spec, loads a fresh store
  per cell on the matrix's ``torch_device``, and emits JSON rows in the
  reference's schema.

Op semantics are shared with the closed-loop runner via ``OpStream`` —
placement/migration/caching schemes see byte-identical request streams,
and a single-tenant run under policy ``none`` is event-for-event identical
to ``run_open_loop``.
"""
from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.middleware import (DELAY, REJECT, AdmissionConfig,
                               AdmissionController)
from ..zoned.faults import FaultInjector, FaultSpec
from .ycsb import (OP_NAMES, READ, OpStream, WorkloadSpec, YCSB, _pct,
                   collect_extras, run_load)


# ======================================================================
# arrival processes
# ======================================================================
class ArrivalProcess:
    """Generates arrival timestamps in [0, duration) virtual seconds."""

    name: str = "arrivals"

    def times(self, rng: np.random.Generator,
              duration: float) -> np.ndarray:
        raise NotImplementedError

    @staticmethod
    def _poisson_times(rng, rate: float, start: float,
                       end: float) -> np.ndarray:
        """Homogeneous Poisson arrivals on [start, end)."""
        span = end - start
        if rate <= 0 or span <= 0:
            return np.empty(0, np.float64)
        out: List[np.ndarray] = []
        t = start
        # draw in chunks; extend until we pass `end`
        chunk = max(16, int(rate * span * 1.2))
        while t < end:
            gaps = rng.exponential(1.0 / rate, size=chunk)
            ts = t + np.cumsum(gaps)
            out.append(ts)
            t = ts[-1]
        times = np.concatenate(out)
        return times[times < end]


@dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Memoryless arrivals at a constant offered rate (ops/virtual-s)."""

    rate: float

    @property
    def name(self) -> str:
        return f"poisson({self.rate:g})"

    def times(self, rng, duration):
        return self._poisson_times(rng, self.rate, 0.0, duration)


@dataclass(frozen=True)
class BurstyArrivals(ArrivalProcess):
    """On-off modulated Poisson: ``burst_rate`` for ``on`` seconds, then
    ``base_rate`` for ``off`` seconds, repeating — the classic open-loop
    burst pattern where queues built during the burst drain (or don't)
    during the off phase."""

    base_rate: float
    burst_rate: float
    on: float
    off: float

    @property
    def name(self) -> str:
        return (f"bursty({self.base_rate:g}->{self.burst_rate:g},"
                f"on={self.on:g},off={self.off:g})")

    def times(self, rng, duration):
        out: List[np.ndarray] = []
        t = 0.0
        while t < duration:
            hi = min(t + self.on, duration)
            out.append(self._poisson_times(rng, self.burst_rate, t, hi))
            t = hi
            if t >= duration:
                break
            hi = min(t + self.off, duration)
            out.append(self._poisson_times(rng, self.base_rate, t, hi))
            t = hi
        return np.concatenate(out) if out else np.empty(0, np.float64)


@dataclass(frozen=True)
class RampArrivals(ArrivalProcess):
    """Linearly ramping rate from ``start_rate`` to ``end_rate`` over the
    run (diurnal load edge), via thinning of a max-rate Poisson stream."""

    start_rate: float
    end_rate: float

    @property
    def name(self) -> str:
        return f"ramp({self.start_rate:g}->{self.end_rate:g})"

    def times(self, rng, duration):
        rmax = max(self.start_rate, self.end_rate)
        cand = self._poisson_times(rng, rmax, 0.0, duration)
        if not len(cand):
            return cand
        rate_t = self.start_rate + (self.end_rate - self.start_rate) \
            * (cand / duration)
        keep = rng.random(len(cand)) < rate_t / rmax
        return cand[keep]


@dataclass(frozen=True)
class DiurnalArrivals(ArrivalProcess):
    """Piecewise-linear multi-ramp rate through ``rates`` knots spread
    evenly over one ``period`` (default: the whole run), closing the loop
    back to the first knot — e.g. ``rates=(low, high, mid, high, low)`` is
    a two-peak day.  Runs longer than ``period`` repeat the profile.
    Implemented by thinning a max-rate Poisson stream."""

    rates: Tuple[float, ...]
    period: Optional[float] = None

    @property
    def name(self) -> str:
        knots = "->".join(f"{r:g}" for r in self.rates)
        if self.period is not None:
            return f"diurnal({knots},T={self.period:g})"
        return f"diurnal({knots})"

    def times(self, rng, duration):
        rates = tuple(self.rates)
        if not rates:
            return np.empty(0, np.float64)
        period = self.period if self.period is not None else duration
        rmax = max(rates)
        cand = self._poisson_times(rng, rmax, 0.0, duration)
        if not len(cand):
            return cand
        xp = np.linspace(0.0, period, len(rates) + 1)
        fp = np.asarray(rates + (rates[0],), np.float64)
        rate_t = np.interp(np.mod(cand, period), xp, fp)
        keep = rng.random(len(cand)) < rate_t / rmax
        return cand[keep]


@dataclass(frozen=True)
class FlashCrowdArrivals(ArrivalProcess):
    """Steady Poisson at ``base_rate`` until ``at``, then an instantaneous
    spike to ``peak_rate`` that decays exponentially back toward the base
    with time constant ``decay`` — the canonical flash-crowd / news-event
    shape.  Expected extra arrivals beyond the base load:
    ``(peak_rate - base_rate) * decay`` (for runs much longer than
    ``at + decay``).  Implemented by thinning a max-rate Poisson stream."""

    base_rate: float
    peak_rate: float
    at: float
    decay: float

    @property
    def name(self) -> str:
        return (f"flash({self.base_rate:g}->{self.peak_rate:g}"
                f"@{self.at:g},tau={self.decay:g})")

    def times(self, rng, duration):
        rmax = max(self.base_rate, self.peak_rate)
        cand = self._poisson_times(rng, rmax, 0.0, duration)
        if not len(cand):
            return cand
        rate_t = np.full(len(cand), float(self.base_rate))
        post = cand >= self.at
        rate_t[post] += (self.peak_rate - self.base_rate) \
            * np.exp(-(cand[post] - self.at) / max(self.decay, 1e-12))
        keep = rng.random(len(cand)) < rate_t / rmax
        return cand[keep]


# ======================================================================
# open-loop runner
# ======================================================================
@dataclass
class OpenLoopResult:
    """Result of one open-loop (sub-)run with queueing/service decomposition.

    One instance describes either a whole single-stream run
    (``run_open_loop``) or one tenant's slice of a multi-tenant run
    (``run_multi_tenant``); serialized by :meth:`to_json` it is exactly one
    row of ``results/storage/scenarios.json``.  Row schema:

    ``workload``        workload (``WorkloadSpec``) name, e.g. ``"A"``.
    ``scheme``          placement scheme (``repro_torch.lsm.db.SCHEMES``).
    ``arrival``         arrival-process descriptor, e.g. ``"poisson(50)"``.
    ``n_arrived``       ops generated by the arrival process (including
                        shed/uncompleted ones).
    ``n_measured``      completed ops that arrived after the warm-up window
                        (the statistics population).
    ``duration``        virtual seconds of the arrival window.
    ``offered_rate``    ``n_arrived / duration`` (ops/virtual-second).
    ``throughput``      completed ops / busy span (arrival start -> last
                        completion).
    ``latency_p``       percentiles (p50/p90/p99/p999/p9999, virtual
                        seconds) of total sojourn time: arrival -> done.
    ``queue_p``         percentiles of queueing delay: arrival -> service
                        start (the wait for a free server, plus any
                        admission-control hold under policy ``delay``).
    ``service_p``       percentiles of service time: start -> done (device
                        time incl. background-job interference).
    ``read_latency_p``  sojourn percentiles over READ ops only.
    ``mean_latency`` / ``mean_queue`` / ``mean_service``
                        means over the measured population; by construction
                        ``mean_latency == mean_queue + mean_service``.
    ``max_queue_depth`` peak number of queued ops (this tenant's ops only
                        in multi-tenant runs; the whole queue otherwise).
    ``op_counts``       executed ops by type (read/update/insert/scan/rmw).
    ``extras``          device/cache/migration counters
                        (``repro_torch.workloads.ycsb.collect_extras``).

    Multi-tenant rows additionally carry (absent on single-stream rows):

    ``tenant``          tenant name from ``TenantSpec``.
    ``policy``          admission policy the run used
                        (``repro_torch.core.middleware.ADMISSION_POLICIES``).
    ``protected``       whether this tenant was exempt from shedding.
    ``admission``       per-tenant admission counters: ``arrived``,
                        ``admitted``, ``rejected``, ``delayed``,
                        ``holding`` (0 after a drained run), ``delay_time``
                        and ``mean_delay`` (virtual seconds); conservation:
                        ``arrived == admitted + rejected + holding``.

    Multi-tenant rows with an SLO target (``TenantSpec.slo_p99``) also
    carry:

    ``slo_p99``         the tenant's sojourn-p99 target (virtual seconds).
    ``slo_met``         whether the measured p99 met the target.
    ``goodput``         ops/s completing *within* the target over the busy
                        span (== ``throughput`` for tenants without a
                        target) — the SLO-attainment quantity
                        ``bench_control`` compares policies on.

    Multi-tenant rows under policy ``feedback`` also carry:

    ``control``         end-of-run control-plane knob summary
                        (``ControlPlane.knob_summary``): ``controller``
                        (``"aimd"``/``"pi"``), ``knobs`` (enabled actuator
                        names), final actuation level ``u`` and the
                        resulting ``pace`` / ``migration`` /
                        ``cache_budget`` knob values (-1.0 = unlimited).

    Fault-injection rows (``run_open_loop(faults=...)`` or
    ``run_multi_tenant(faults=...)``) additionally carry:

    ``fault``           the ``FaultSpec.label`` schedule description.
    ``availability``    completed ops / offered ops — below 1.0 when a
                        crash killed in-flight ops or refused arrivals
                        during the outage.  On per-tenant rows the
                        denominator excludes admission-shed ops (shedding
                        is policy, not unavailability).
    ``stall_p``         sojourn percentiles over ops that *arrived inside a
                        stall window* (the during-stall tail), when the
                        spec has stall windows.
    ``crash``           crash/recovery accounting, when the spec has a
                        crash point: ``downtime`` (crash -> serving again,
                        virtual s), ``lost_in_flight`` (ops killed by the
                        crash), ``refused`` (arrivals during the outage),
                        plus ``DB.recovery``'s ``live_wal_zones`` /
                        ``replayed_gens`` / ``replayed_records``; on
                        per-tenant rows ``lost_in_flight``/``refused`` are
                        this tenant's share.
    ``recovery_slo_s`` / ``recovery_slo_met``
                        recovery-time SLO accounting on crash rows, when
                        the spec sets ``FaultSpec.recovery_slo_s``:
                        the downtime budget and whether the measured
                        downtime stayed within it.

    Drift rows (``repro_torch.workloads.drift.run_drift``) carry instead of the
    multi-tenant block (``tenant`` names the drift tenant; no admission
    columns):

    ``drift``           the ``TraceProgram`` name, e.g. ``"rotate~poisson"``.
    ``phases``          per-phase metric windows, one dict per phase the
                        tenant was live in: ``phase`` (index), ``name``,
                        ``t0``/``t1`` (window, virtual s relative to run
                        start), ``workload``, ``n_arrived``,
                        ``n_completed``, ``n_dropped``, ``n_measured``,
                        ``throughput`` (completions / window length) and
                        ``latency_p99``/``queue_p99``/``service_p99``.
                        Ops are assigned to the phase they *arrived* in,
                        so a boundary straddler counts in exactly one
                        window and ``sum(phase n_arrived) == n_arrived``.
    ``n_completed``     completed ops over the whole program
                        (``n_arrived == n_completed + dropped``).
    ``dropped``         departed-tenant ops cancelled while still queued
                        at their departure boundary.
    ``drain_violations``
                        departed-tenant ops completing after the
                        ``boundary + TraceProgram.drain_s`` deadline
                        (kept at 0 by the engine's drop-at-boundary
                        semantics unless a single op's service time
                        exceeds the grace window).
    ``rank_flips``      run-level summary attached by ``bench_drift``
                        (absent on raw sweep rows): how many phase
                        boundaries changed the cross-scheme throughput
                        ordering of this row's (program x arrival x
                        tenant x budget) group.
    """

    name: str                      # workload name
    scheme: str
    arrival: str
    n_arrived: int
    n_measured: int                # completed ops past warm-up
    duration: float                # virtual seconds of arrivals
    offered_rate: float            # arrivals / duration
    throughput: float              # completed ops / busy span
    latency_p: Dict[str, float]    # total sojourn (arrival -> done)
    queue_p: Dict[str, float]      # queueing delay (arrival -> start)
    service_p: Dict[str, float]    # service time   (start -> done)
    read_latency_p: Dict[str, float]
    max_queue_depth: int
    op_counts: Dict[str, int]
    extras: Dict[str, float]
    mean_latency: float = 0.0
    mean_queue: float = 0.0
    mean_service: float = 0.0
    # set only on per-tenant rows from run_multi_tenant
    tenant: Optional[str] = None
    policy: Optional[str] = None
    protected: Optional[bool] = None
    admission: Optional[Dict[str, float]] = None
    goodput: Optional[float] = None
    slo_p99: Optional[float] = None
    slo_met: Optional[bool] = None
    # set only on feedback-policy tenant rows (ControlPlane.knob_summary)
    control: Optional[Dict] = None
    # set only on fault-injection rows (run_open_loop(faults=...) and
    # run_multi_tenant(faults=...))
    fault: Optional[str] = None
    availability: Optional[float] = None
    stall_p: Optional[Dict[str, float]] = None
    crash: Optional[Dict[str, float]] = None
    recovery_slo_s: Optional[float] = None
    recovery_slo_met: Optional[bool] = None
    # set only on drift rows (repro_torch.workloads.drift.run_drift)
    drift: Optional[str] = None
    phases: Optional[List[Dict]] = None
    n_completed: Optional[int] = None
    dropped: Optional[int] = None
    drain_violations: Optional[int] = None
    rank_flips: Optional[int] = None

    def row(self) -> str:
        tag = ""
        if self.drift is not None:
            tag = f"[{self.tenant}@{self.drift}] "
        elif self.tenant is not None:
            star = "*" if self.protected else ""
            tag = f"[{self.tenant}{star}/{self.policy}] "
        shed = ""
        if self.admission and self.admission.get("rejected"):
            shed = f" shed={int(self.admission['rejected'])}"
        extra = ""
        if self.fault is not None:
            extra = f" fault={self.fault} avail={self.availability:.4f}"
        return (f"{tag}{self.scheme:7s} {self.name:4s} {self.arrival:28s} "
                f"offered={self.offered_rate:8.1f}/s "
                f"thpt={self.throughput:8.1f}/s "
                f"p99={self.latency_p.get('p99', 0)*1e3:9.2f}ms "
                f"(queue {self.queue_p.get('p99', 0)*1e3:9.2f}ms / "
                f"service {self.service_p.get('p99', 0)*1e3:8.2f}ms)"
                f"{shed}{extra}")

    def to_json(self) -> Dict:
        d = {
            "workload": self.name, "scheme": self.scheme,
            "arrival": self.arrival, "n_arrived": self.n_arrived,
            "n_measured": self.n_measured, "duration": self.duration,
            "offered_rate": self.offered_rate, "throughput": self.throughput,
            "latency_p": self.latency_p, "queue_p": self.queue_p,
            "service_p": self.service_p,
            "read_latency_p": self.read_latency_p,
            "mean_latency": self.mean_latency, "mean_queue": self.mean_queue,
            "mean_service": self.mean_service,
            "max_queue_depth": self.max_queue_depth,
            "op_counts": self.op_counts, "extras": self.extras,
        }
        if self.drift is not None:
            d.update(tenant=self.tenant, drift=self.drift,
                     phases=self.phases, n_completed=self.n_completed,
                     dropped=self.dropped,
                     drain_violations=self.drain_violations)
            if self.rank_flips is not None:
                d["rank_flips"] = self.rank_flips
        elif self.tenant is not None:
            d.update(tenant=self.tenant, policy=self.policy,
                     protected=self.protected, admission=self.admission,
                     goodput=self.goodput)
            if self.slo_p99 is not None:
                d.update(slo_p99=self.slo_p99, slo_met=self.slo_met)
            if self.control is not None:
                d["control"] = self.control
        if self.fault is not None:
            d.update(fault=self.fault, availability=self.availability)
            if self.stall_p is not None:
                d["stall_p"] = self.stall_p
            if self.crash is not None:
                d["crash"] = self.crash
            if self.recovery_slo_s is not None:
                d.update(recovery_slo_s=self.recovery_slo_s,
                         recovery_slo_met=self.recovery_slo_met)
        return d


def _mean(arr: np.ndarray) -> float:
    return float(arr.mean()) if len(arr) else 0.0


def run_open_loop(db, spec: WorkloadSpec, arrival: ArrivalProcess,
                  duration: float, n_keys: int, *, warmup: float = 0.0,
                  max_concurrency: int = 64, seed: int = 1,
                  drain: bool = True, read_batch: int = 1,
                  faults: Optional[FaultSpec] = None) -> OpenLoopResult:
    """Open-loop run: ops arrive per ``arrival`` regardless of completion.

    A bounded pool of ``max_concurrency`` server processes (the store's
    request threads) pulls from the arrival queue; queueing delay is the
    wait for a server, service time is the op's execution (which itself
    includes device-queue interference from background jobs).  Ops arriving
    before ``warmup`` complete normally but are excluded from statistics.
    The arrival stream stops at ``duration``; with ``drain`` the queue is
    serviced to empty afterwards (ops past the limit still complete).
    With ``drain=False`` the run hard-stops at the time limit; ops still
    queued or in flight are excluded from statistics but remain pending
    work in the store — a later ``db.drain()`` or follow-up run on the
    same DB executes them, exactly as real queued requests would.

    ``read_batch`` > 1 turns on the batched read path: a server pulling a
    point READ from the queue also takes up to ``read_batch - 1`` further
    *consecutively queued* point reads (concurrently-arrived gets) and
    services them in one ``LSMTree.get_batch`` call — one vectorized Bloom
    probe over every (key x candidate-SST) pair instead of per-key python
    probing.  Results are identical to ``read_batch=1``; batched ops share
    a service start and completion time.  The default (1) keeps the
    per-key path, preserving event-for-event equivalence with
    ``run_multi_tenant`` (which does not batch).

    ``faults`` arms a :class:`repro_torch.zoned.faults.FaultSpec` against the
    run: stall/slow/zone-reset windows perturb the devices underneath the
    unchanged engine, while ``crash_at`` kills the store mid-run
    (``DB.crash()``) — every queued or in-flight op is lost, arrivals
    during the outage are refused, and after ``DB.reopen()`` + WAL replay
    a fresh server fleet resumes the remaining arrival stream.  The result
    row then carries ``fault`` / ``availability`` / ``stall_p`` / ``crash``
    (see :class:`OpenLoopResult`).
    """
    sim = db.sim
    rng = np.random.default_rng(seed + 2)
    rel = arrival.times(rng, duration)
    n = len(rel)
    stream = OpStream(db, spec, n_ops=n, n_keys=n_keys, seed=seed)
    t0 = sim.now
    arrive = np.full(n, np.nan)
    start = np.full(n, np.nan)
    done = np.full(n, np.nan)
    queue: deque = deque()
    idle: List = []                       # events of parked servers
    state = {"closed": False, "max_depth": 0, "next": 0}
    crash_info: Dict[str, float] = {}

    def dispatcher():
        while state["next"] < n:
            i = state["next"]
            at = t0 + float(rel[i])
            if at > sim.now:
                yield at - sim.now   # bare-delay: no Event
            arrive[i] = sim.now
            state["next"] = i + 1
            queue.append(i)
            if len(queue) > state["max_depth"]:
                state["max_depth"] = len(queue)
            if idle:
                idle.pop().succeed()
        state["closed"] = True
        while idle:
            idle.pop().succeed()

    def server():
        while True:
            while not queue:
                if state["closed"]:
                    return
                ev = sim.event()
                idle.append(ev)
                yield ev
            i = queue.popleft()
            if read_batch > 1 and stream.is_point_read(i):
                batch = [i]
                while (queue and len(batch) < read_batch
                       and stream.is_point_read(queue[0])):
                    batch.append(queue.popleft())
                now = sim.now
                for j in batch:
                    start[j] = now
                yield from stream.execute_read_batch(batch)
                now = sim.now
                for j in batch:
                    done[j] = now
                continue
            start[i] = sim.now
            yield from stream.execute(i)
            done[i] = sim.now

    def crash_ctl():
        at = t0 + faults.crash_at
        if at > sim.now:
            yield at - sim.now   # bare-delay: no Event
        down0 = sim.now
        if faults.crash_shard is not None:
            # per-shard power loss (sharded stores): the dispatcher, the
            # queue and every server not caught mid-op on the crashed
            # shard keep serving; ops routed to the down shard park at
            # the router and complete after recovery — only the shard's
            # own in-flight ops are lost
            info = db.crash_shard(faults.crash_shard)
            crash_info["lost_in_flight"] = int(info["lost_in_flight"])
            killed = {id(p) for p in info["killed_processes"]}
            rec = yield from db.reopen_shard_gen(faults.crash_shard)
            crash_info.update(rec)
            crash_info["downtime"] = sim.now - down0
            crash_info["refused"] = 0
            # replace exactly the servers that died with the shard
            for _ in range(sum(1 for p in procs if id(p) in killed)):
                procs.append(db.submit(server()))
            return
        crash_info["lost_in_flight"] = \
            int((~np.isnan(arrive) & np.isnan(done)).sum())
        db.crash()                 # kills the dispatcher and every server
        queue.clear()
        idle.clear()
        rec = yield from db.reopen_gen()
        crash_info.update(rec)
        crash_info["downtime"] = sim.now - down0
        # clients that knocked during the outage were refused: account
        # their arrival, skip their execution
        refused = 0
        while state["next"] < n and t0 + float(rel[state["next"]]) <= sim.now:
            i = state["next"]
            arrive[i] = t0 + float(rel[i])
            state["next"] = i + 1
            refused += 1
        crash_info["refused"] = refused
        # the injector's processes died with the crash: re-arm the fault
        # windows that have not fired yet on the original schedule
        FaultInjector(db, faults).arm(t0=t0, after=sim.now - t0)
        # fresh serving fleet resumes the remaining arrival stream
        for _ in range(max_concurrency):
            db.submit(server())
        db.submit(dispatcher())

    procs = [db.submit(server()) for _ in range(max_concurrency)]
    procs.append(db.submit(dispatcher()))
    crashing = faults is not None and faults.crash_at is not None
    if faults is not None:
        FaultInjector(db, faults).arm()
        if crashing:
            sim.process(crash_ctl())
    if drain:
        if crashing:
            # the phase-1 processes die at the crash, so their completion
            # events never fire: drive the run to global quiescence instead
            sim.run()
        else:
            for p in procs:
                sim.run_until(p)
    else:
        # hard time limit: stop at the end of the arrival window; ops still
        # queued or in flight are excluded from statistics below
        db.run_for(t0 + duration - sim.now)
    busy_span = max(sim.now - t0, 1e-12)

    completed = ~np.isnan(done)
    if crashing and completed.any():
        # the crash path ran to global quiescence (sim.run()), which
        # includes background compaction settling after the last op; clamp
        # the busy span to the last completion so throughput stays
        # comparable with non-crash cells (run_until stops there)
        busy_span = max(float(done[completed].max()) - t0, 1e-12)
    measured = completed & (arrive - t0 >= warmup)
    total = done - arrive
    qdel = start - arrive
    serv = done - start
    reads = (stream.ops.codes == READ) & measured
    fault_fields: Dict = {}
    if faults is not None:
        fault_fields["fault"] = faults.label
        fault_fields["availability"] = float(completed.sum()) / max(n, 1)
        if faults.stalls:
            smask = np.zeros(n, bool)
            for w in faults.stalls:
                smask |= ((arrive >= t0 + w.at)
                          & (arrive < t0 + w.at + w.duration))
            fault_fields["stall_p"] = _pct(total[smask & measured])
        if crashing:
            fault_fields["crash"] = dict(crash_info)
            if faults.recovery_slo_s is not None:
                fault_fields["recovery_slo_s"] = faults.recovery_slo_s
                fault_fields["recovery_slo_met"] = bool(
                    crash_info.get("downtime", float("inf"))
                    <= faults.recovery_slo_s)
    return OpenLoopResult(
        name=spec.name, scheme=db.scheme, arrival=arrival.name,
        n_arrived=n, n_measured=int(measured.sum()), duration=duration,
        offered_rate=n / max(duration, 1e-12),
        throughput=float(completed.sum()) / busy_span,
        latency_p=_pct(total[measured]), queue_p=_pct(qdel[measured]),
        service_p=_pct(serv[measured]),
        read_latency_p=_pct(total[reads]),
        mean_latency=_mean(total[measured]), mean_queue=_mean(qdel[measured]),
        mean_service=_mean(serv[measured]),
        max_queue_depth=state["max_depth"],
        # snapshot: with drain=False the stream keeps mutating its counts
        # if leftover queued ops execute on a later drain
        op_counts=dict(stream.counts), extras=collect_extras(db),
        **fault_fields)


# ======================================================================
# multi-tenant open-loop serving
# ======================================================================
@dataclass(frozen=True)
class TenantSpec:
    """One tenant of a multi-tenant open-loop run.

    ``workload`` may be a YCSB letter key ("A".."F") or a full
    ``WorkloadSpec``; ``arrival`` is this tenant's own arrival process.
    ``protected`` marks the tenant exempt from admission-control
    shedding/delaying — the SLO tenant the policies exist to protect.
    ``slo_p99`` is the tenant's sojourn-p99 target in virtual seconds: it
    defines the row's ``goodput``/``slo_met`` columns and, on protected
    tenants under policy ``feedback``, drives the SLO feedback controller
    (``repro_torch.obs.control.ControlPlane``).
    """

    name: str
    workload: Union[str, WorkloadSpec]
    arrival: ArrivalProcess
    protected: bool = False
    slo_p99: Optional[float] = None


@dataclass
class MultiTenantResult:
    """Result of one multi-tenant run: per-tenant ``OpenLoopResult`` slices
    (each carrying tenant/policy/admission fields) plus shared aggregates."""

    scheme: str
    policy: str
    duration: float
    n_arrived: int                  # all tenants
    n_completed: int                # all tenants
    max_queue_depth: int            # shared service queue
    tenants: List[OpenLoopResult]
    extras: Dict[str, float]

    def by_tenant(self, name: str) -> OpenLoopResult:
        for t in self.tenants:
            if t.tenant == name:
                return t
        raise KeyError(name)

    def rows(self) -> List[Dict]:
        return [t.to_json() for t in self.tenants]

    def row(self) -> str:
        return "\n".join(t.row() for t in self.tenants)


def run_multi_tenant(db, tenants: Sequence[TenantSpec], duration: float,
                     n_keys: int, *, warmup: float = 0.0,
                     max_concurrency: int = 64, seed: int = 1,
                     drain: bool = True,
                     policy: Union[AdmissionConfig, str, None] = None,
                     faults: Optional[FaultSpec] = None
                     ) -> MultiTenantResult:
    """N tenants with independent arrival processes share one store.

    Each tenant gets its own seeded ``OpStream`` (distinct key-popularity
    scramble and op mix) and its own arrival timestamps; the merged arrival
    sequence feeds one bounded pool of ``max_concurrency`` servers, so
    tenants contend for service exactly as co-located workloads contend for
    a store's request threads.  Every arrival passes through
    ``db.admission`` (``AdmissionController``): shed ops count in the
    tenant's ``admission`` row but never execute; delayed ops are held
    until store pressure clears, the hold time showing up as queueing
    delay.  ``policy`` (a policy name or full ``AdmissionConfig``)
    reconfigures ``db.admission`` for this run; tenants flagged
    ``protected`` are added to the controller's protected set.

    Under policy ``"feedback"`` the run additionally spins up an SLO
    feedback controller (``repro_torch.obs.control.ControlPlane``): every
    completion's sojourn is observed per tenant, and an AIMD daemon loop
    drives the non-protected tenants' token-bucket rates toward the
    protected tenants' ``TenantSpec.slo_p99`` targets (and away from
    compaction debt above ``AdmissionConfig.debt_threshold``).

    ``faults`` arms a :class:`repro_torch.zoned.faults.FaultSpec` against the
    run exactly as in ``run_open_loop``: stall/slow/zone-reset windows
    perturb the devices under the unchanged engine, ``crash_at`` kills the
    store mid-run (queued, in-flight and admission-held ops are lost,
    arrivals during the outage are refused per tenant) and recovery
    resumes the remaining merged arrival stream with a fresh server fleet.
    Per-tenant rows then carry ``fault``/``availability``/``stall_p``/
    ``crash`` columns (see :class:`OpenLoopResult`).

    Accounting mirrors ``run_open_loop`` per tenant (queueing vs service
    decomposition, warm-up exclusion, ``drain`` semantics); with one
    tenant and policy ``none`` the run is event-for-event identical to
    ``run_open_loop``.
    """
    sim = db.sim
    names = [t.name for t in tenants]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names: {names}")
    if faults is not None and faults.crash_shard is not None:
        raise ValueError("per-shard crashes (FaultSpec.crash_shard) are a "
                         "single-stream feature; use run_open_loop")
    # fresh controller per run: counters, per-run protected-set widening
    # and the queue gauge must not leak into later runs on the same store.
    # The store wires its own pressure signals — backend WAL pressure and
    # the compaction-debt gauge on a DB, per-shard pressure callbacks on a
    # ShardedDB — and re-installs metrics; policy None keeps the store's
    # configured policy via its pristine base_cfg.
    ctrl = db.fresh_admission(policy)
    prot = frozenset(t.name for t in tenants if t.protected)
    if prot:
        # rebind (never mutate) the config: callers may share one
        # AdmissionConfig across runs/cells with different tenant mixes
        ctrl.cfg = replace(ctrl.cfg,
                           protected=frozenset(ctrl.cfg.protected) | prot)
    control = None
    if ctrl.cfg.policy == "feedback":
        from ..obs.control import ControlPlane
        control = ControlPlane(
            sim, ctrl,
            targets={t.name: t.slo_p99 for t in tenants
                     if t.protected and t.slo_p99},
            debt_gauge=ctrl.debt_gauge,
            registry=getattr(db, "metrics", None),
            db=db)
        control.start()

    specs = [YCSB[t.workload] if isinstance(t.workload, str) else t.workload
             for t in tenants]
    # per-tenant seeds: tenant 0 matches run_open_loop's (seed + 2 arrival
    # rng, seed op stream) so the single-tenant differential holds; the
    # 9973 stride keeps tenants' streams decorrelated
    rels, streams = [], []
    for ti, t in enumerate(tenants):
        rng = np.random.default_rng(seed + 2 + 9973 * ti)
        rels.append(t.arrival.times(rng, duration))
        streams.append(OpStream(db, specs[ti], n_ops=len(rels[ti]),
                                n_keys=n_keys, seed=seed + 9973 * ti))
        # tag writes with the originating tenant so flushed bytes (and
        # hence compaction debt) attribute back to them
        streams[-1].tenant = t.name
    m_at = (np.concatenate(rels) if rels else np.empty(0, np.float64))
    m_ti = np.concatenate([np.full(len(r), ti, np.int64)
                           for ti, r in enumerate(rels)]) \
        if rels else np.empty(0, np.int64)
    m_i = np.concatenate([np.arange(len(r), dtype=np.int64) for r in rels]) \
        if rels else np.empty(0, np.int64)
    order = np.argsort(m_at, kind="stable")   # ties: tenant order
    m_at, m_ti, m_i = m_at[order], m_ti[order], m_i[order]
    m = len(m_at)

    t0 = sim.now
    arrive = [np.full(len(r), np.nan) for r in rels]
    start = [np.full(len(r), np.nan) for r in rels]
    done = [np.full(len(r), np.nan) for r in rels]
    shed = [np.zeros(len(r), bool) for r in rels]   # admission-rejected
    queue: deque = deque()
    idle: List = []                       # events of parked servers
    depth = [0] * len(tenants)            # per-tenant ops in queue
    tmax_depth = [0] * len(tenants)
    state = {"closed": False, "max_depth": 0, "dispatched": False,
             "holding": 0, "next": 0}
    crash_info: Dict[str, float] = {}
    lost_t = [0] * len(tenants)           # per-tenant crash accounting
    refused_t = [0] * len(tenants)
    ctrl.queue_gauge = lambda: len(queue)

    def _enqueue(ti: int, i: int) -> None:
        queue.append((ti, i))
        depth[ti] += 1
        if depth[ti] > tmax_depth[ti]:
            tmax_depth[ti] = depth[ti]
        if len(queue) > state["max_depth"]:
            state["max_depth"] = len(queue)
        if idle:
            idle.pop().succeed()

    def _maybe_close() -> None:
        # servers may only exit once arrivals AND held ops are exhausted
        if state["dispatched"] and state["holding"] == 0 \
                and not state["closed"]:
            state["closed"] = True
            while idle:
                idle.pop().succeed()

    def held(ti: int, i: int):
        yield from ctrl.hold(names[ti])
        state["holding"] -= 1
        _enqueue(ti, i)
        _maybe_close()

    def dispatcher():
        # cursor-based (not `for j in range(m)`) so the post-crash
        # respawn resumes the merged stream where the outage left it
        while state["next"] < m:
            j = state["next"]
            at = t0 + float(m_at[j])
            if at > sim.now:
                yield at - sim.now   # bare-delay: no Event
            ti, i = int(m_ti[j]), int(m_i[j])
            arrive[ti][i] = sim.now
            state["next"] = j + 1
            verdict = ctrl.decide(names[ti])
            if verdict == REJECT:
                shed[ti][i] = True
                continue
            if verdict == DELAY:
                state["holding"] += 1
                sim.process(held(ti, i))
                continue
            _enqueue(ti, i)
        state["dispatched"] = True
        _maybe_close()

    def server():
        while True:
            while not queue:
                if state["closed"]:
                    return
                ev = sim.event()
                idle.append(ev)
                yield ev
            ti, i = queue.popleft()
            depth[ti] -= 1
            start[ti][i] = sim.now
            yield from streams[ti].execute(i)
            done[ti][i] = sim.now
            if control is not None:
                control.observe(names[ti], sim.now - arrive[ti][i])

    def crash_ctl():
        # mirrors run_open_loop's crash controller, with per-tenant
        # accounting: everything queued, in flight, or admission-held dies
        # with the store; arrivals during the outage are refused
        at = t0 + faults.crash_at
        if at > sim.now:
            yield at - sim.now   # bare-delay: no Event
        for ti in range(len(tenants)):
            lost_t[ti] = int((~np.isnan(arrive[ti]) & ~shed[ti]
                              & np.isnan(done[ti])).sum())
        down0 = sim.now
        db.crash()                 # kills dispatcher, servers, held ops
        queue.clear()
        idle.clear()
        for ti in range(len(tenants)):
            depth[ti] = 0
        state["holding"] = 0       # held ops died with their processes
        rec = yield from db.reopen_gen()
        crash_info.update(rec)
        crash_info["downtime"] = sim.now - down0
        while state["next"] < m and \
                t0 + float(m_at[state["next"]]) <= sim.now:
            j = state["next"]
            ti, i = int(m_ti[j]), int(m_i[j])
            arrive[ti][i] = t0 + float(m_at[j])
            state["next"] = j + 1
            refused_t[ti] += 1
        crash_info["lost_in_flight"] = sum(lost_t)
        crash_info["refused"] = sum(refused_t)
        # re-arm the not-yet-fired fault windows on the original schedule
        FaultInjector(db, faults).arm(t0=t0, after=sim.now - t0)
        if control is not None:
            control.start()    # the AIMD loop died with the crash
        for _ in range(max_concurrency):
            db.submit(server())
        db.submit(dispatcher())

    procs = [db.submit(server()) for _ in range(max_concurrency)]
    procs.append(db.submit(dispatcher()))
    crashing = faults is not None and faults.crash_at is not None
    if faults is not None:
        FaultInjector(db, faults).arm()
        if crashing:
            sim.process(crash_ctl())
    if drain:
        if crashing:
            # phase-1 processes die at the crash and their completion
            # events never fire: drive to global quiescence instead
            sim.run()
        else:
            for p in procs:
                sim.run_until(p)
    else:
        # hard time limit (see run_open_loop): shed/held/queued ops that
        # did not complete are excluded from statistics below
        db.run_for(t0 + duration - sim.now)
    busy_span = max(sim.now - t0, 1e-12)
    if crashing:
        last = max((float(d[~np.isnan(d)].max())
                    for d in done if (~np.isnan(d)).any()),
                   default=sim.now)
        # clamp to the last completion (see run_open_loop's crash path)
        busy_span = max(last - t0, 1e-12)
    ctrl.queue_gauge = None   # this run's queue is dead; don't let later
    # DB.submit calls read pressure off it
    control_summary = None
    if control is not None:
        # snapshot before stop(): stop restores every knob to neutral
        control_summary = control.knob_summary()
        control.stop()        # retire the control daemon loop with the run

    extras = collect_extras(db)
    results: List[OpenLoopResult] = []
    for ti, t in enumerate(tenants):
        arr, st, dn = arrive[ti], start[ti], done[ti]
        completed = ~np.isnan(dn)
        measured = completed & (arr - t0 >= warmup)
        total = dn - arr
        qdel = st - arr
        serv = dn - st
        reads = (streams[ti].ops.codes == READ) & measured
        throughput = float(completed.sum()) / busy_span
        latency_p = _pct(total[measured])
        # SLO-attainment columns: goodput counts only completions within
        # the tenant's sojourn target (== throughput without a target)
        slo_fields: Dict = {"goodput": throughput}
        if t.slo_p99 is not None:
            within = int((total[completed] <= t.slo_p99).sum())
            slo_fields["goodput"] = within / busy_span
            slo_fields["slo_p99"] = t.slo_p99
            slo_fields["slo_met"] = bool(latency_p["p99"] <= t.slo_p99)
        fault_fields: Dict = {}
        if faults is not None:
            fault_fields["fault"] = faults.label
            served = len(arr) - int(shed[ti].sum())
            fault_fields["availability"] = \
                float(completed.sum()) / max(served, 1)
            if faults.stalls:
                smask = np.zeros(len(arr), bool)
                for w in faults.stalls:
                    smask |= ((arr >= t0 + w.at)
                              & (arr < t0 + w.at + w.duration))
                fault_fields["stall_p"] = _pct(total[smask & measured])
            if crashing:
                cd = dict(crash_info)
                cd["lost_in_flight"] = lost_t[ti]
                cd["refused"] = refused_t[ti]
                fault_fields["crash"] = cd
                if faults.recovery_slo_s is not None:
                    fault_fields["recovery_slo_s"] = faults.recovery_slo_s
                    fault_fields["recovery_slo_met"] = bool(
                        crash_info.get("downtime", float("inf"))
                        <= faults.recovery_slo_s)
        results.append(OpenLoopResult(
            name=specs[ti].name, scheme=db.scheme, arrival=t.arrival.name,
            n_arrived=len(arr), n_measured=int(measured.sum()),
            duration=duration,
            offered_rate=len(arr) / max(duration, 1e-12),
            throughput=throughput,
            latency_p=latency_p, queue_p=_pct(qdel[measured]),
            service_p=_pct(serv[measured]),
            read_latency_p=_pct(total[reads]),
            mean_latency=_mean(total[measured]),
            mean_queue=_mean(qdel[measured]),
            mean_service=_mean(serv[measured]),
            max_queue_depth=tmax_depth[ti],
            op_counts=dict(streams[ti].counts), extras=extras,
            tenant=t.name, policy=ctrl.policy_label, protected=t.protected,
            admission=ctrl.admission_summary(t.name),
            control=control_summary,
            **slo_fields, **fault_fields))
    return MultiTenantResult(
        scheme=db.scheme, policy=ctrl.policy_label, duration=duration,
        n_arrived=m,
        n_completed=sum(int((~np.isnan(d)).sum()) for d in done),
        max_queue_depth=state["max_depth"], tenants=results, extras=extras)


# ======================================================================
# scenario matrix
# ======================================================================
@dataclass(frozen=True)
class ScenarioCell:
    """One fully-resolved cell of the matrix."""

    scheme: str
    workload: WorkloadSpec
    arrival: ArrivalProcess
    ssd_zones: int
    fault: Optional[FaultSpec] = None
    # Bloom bits-per-key override for this cell's store (None = the
    # scenario default) — the filter-sweep axis
    filter_bits: Optional[int] = None
    # sharding axis: shards > 1 runs the cell on a ShardedDB
    # (repro_torch.cluster) with the given routing policy; rebalance arms the
    # telemetry-driven online splitter (range routing only)
    shards: int = 1
    routing: str = "hash"
    rebalance: bool = False

    @property
    def name(self) -> str:
        base = (f"{self.scheme}/{self.workload.name}/"
                f"{self.arrival.name}/z{self.ssd_zones}")
        if self.filter_bits is not None:
            base += f"/fb{self.filter_bits}"
        if self.shards > 1:
            base += f"/sh{self.shards}-{self.routing}"
            if self.rebalance:
                base += "-rb"
        if self.fault is not None:
            base += f"/f:{self.fault.name}"
        return base


@dataclass(frozen=True)
class MultiTenantCell:
    """One fully-resolved multi-tenant cell: a tenant mix under one
    admission policy on one scheme/SSD budget (optionally with a fault
    schedule armed against the run)."""

    scheme: str
    tenants: Tuple[TenantSpec, ...]
    policy: Union[str, AdmissionConfig]
    ssd_zones: int
    fault: Optional[FaultSpec] = None

    @property
    def policy_name(self) -> str:
        if isinstance(self.policy, str):
            return self.policy
        return self.policy.label or self.policy.policy

    @property
    def name(self) -> str:
        mix = "+".join(t.name for t in self.tenants)
        base = (f"{self.scheme}/mt[{mix}]/{self.policy_name}"
                f"/z{self.ssd_zones}")
        if self.fault is not None:
            base += f"/f:{self.fault.name}"
        return base


@dataclass
class ScenarioMatrix:
    """Declarative sweep of (scheme x workload x arrival x SSD budget) —
    or, when ``tenants`` is set, (scheme x tenant-mix x admission policy x
    SSD budget).

    ``workloads`` entries may be YCSB letter keys ("A".."F") or full
    ``WorkloadSpec``s.  Each cell gets a freshly loaded store (same
    methodology as benchmarks/storage_exps.py: load, drain WAL, run while
    the compaction backlog is live), then an open-loop run.  Rows land in
    a JSON artifact (``results/storage/scenarios.json``) consumed by
    ``benchmarks/report.py``; the row schema is documented on
    :class:`OpenLoopResult` (``run`` adds ``cell`` — the cell name — and
    ``ssd_zones`` to every row).

    Multi-tenant mode: ``tenants`` is a list of tenant *mixes* (each a
    sequence of ``TenantSpec``); ``workloads``/``arrivals`` are ignored and
    every cell runs ``run_multi_tenant`` under each entry of ``policies``
    (policy names or ``AdmissionConfig``s), emitting one row *per tenant*
    per cell.

    Fault mode: ``faults`` sweeps cells across ``FaultSpec``s (device
    stalls, bandwidth degradation, zone resets, mid-run crash +
    recovery) — in single-stream *and* multi-tenant mode; ``None``
    entries keep the undisturbed baseline cell.  Fault rows carry
    ``fault``/``availability``/``stall_p``/``crash`` fields (per tenant
    in multi-tenant mode) and are rendered by
    ``benchmarks.report.fault_recovery_table``.

    Telemetry: ``telemetry=True`` (or a sample period) attaches the
    ``repro_torch.obs`` metrics bus to every cell's store; with
    ``timeline_dir`` each cell dumps a timeline artifact
    (``results/storage/timelines/*.json`` schema).  Telemetry is
    pull-only and never changes a cell's rows.
    """

    schemes: Sequence[str]
    workloads: Sequence[Union[str, WorkloadSpec]]
    # either one list for every workload, or {workload name: list} to give
    # each workload its own (e.g. per-workload-calibrated) arrival rates
    arrivals: Union[Sequence[ArrivalProcess],
                    Mapping[str, Sequence[ArrivalProcess]]]
    ssd_zone_budgets: Sequence[int] = (20,)
    duration: float = 600.0            # virtual seconds of arrivals
    warmup: float = 60.0
    max_concurrency: int = 64
    key_div: int = 1                   # dataset divisor (quick sweeps)
    seed: int = 1
    db_factory: Optional[object] = None   # (scheme, ssd_zones) -> loaded db
    tenants: Sequence[Sequence[TenantSpec]] = ()
    policies: Sequence[Union[str, AdmissionConfig]] = ("none",)
    # fault-injection sweep dimension (single-stream AND multi-tenant
    # cells); None = the undisturbed baseline cell
    faults: Sequence[Optional[FaultSpec]] = (None,)
    # Bloom filter-bits sweep dimension (single-stream cells only): each
    # non-None entry loads the cell's store with that
    # ``filter_bits_per_key``; rows then carry a ``filter_bits`` column
    # (FP rate x throughput pivot: ``benchmarks.report.filter_sweep_table``)
    filter_bits: Sequence[Optional[int]] = (None,)
    # batched read path: >1 services consecutively queued point reads via
    # ``LSMTree.get_batch`` (see ``run_open_loop``)
    read_batch: int = 1
    # sharding sweep (single-stream cells only): each entry > 1 runs the
    # cell on a ``repro_torch.cluster.ShardedDB`` with that many shard stores;
    # ``routing`` picks the router ("hash" | "range") and ``rebalance``
    # sweeps the online splitter on/off (ignored at shards == 1, where
    # the sharded facade is event-identical to a bare DB)
    shards: Sequence[int] = (1,)
    routing: str = "hash"
    rebalance: Sequence[bool] = (False,)
    # telemetry (repro_torch.obs): True (or a sample period in virtual seconds)
    # attaches a MetricsRegistry to every cell's store — pull-only, so
    # rows stay byte-identical (asserted by CI grid-smoke); with
    # timeline_dir each cell also dumps its timeline artifact there
    telemetry: Union[bool, float] = False
    timeline_dir: Optional[Union[str, Path]] = None
    # serving scenario family (repro_torch.workloads.serving): non-empty
    # serving_policies adds one ServingCell per policy x serving_workload
    # x arrival x serving_pool — KV-cache tiering policies selectable the
    # way storage schemes are
    serving_policies: Sequence[str] = ()
    serving_workloads: Sequence[object] = ()      # ServingWorkload
    serving_pools: Sequence[object] = ()          # ServingPool
    serving_admission: Union[str, AdmissionConfig, None] = None
    serving_costs: Optional[object] = None        # ServingCosts
    # drift scenario family (repro_torch.workloads.drift): each TraceProgram
    # adds one DriftCell per scheme x SSD budget; the cell runs the
    # program's own virtual-time schedule (``duration`` is ignored) and
    # emits one per-tenant row with ``drift``/``phases`` columns
    drift_programs: Sequence[object] = ()         # TraceProgram
    # where the cells' stores probe their filters and serving pools keep
    # their device tier (``db_factory`` carries its own device)
    torch_device: str = "cuda"
    results: List[OpenLoopResult] = field(default_factory=list)

    def _workload_spec(self, w) -> WorkloadSpec:
        return YCSB[w] if isinstance(w, str) else w

    def _arrivals_of(self, spec: WorkloadSpec) -> Sequence[ArrivalProcess]:
        if isinstance(self.arrivals, Mapping):
            return self.arrivals[spec.name]
        return self.arrivals

    def _serving_cells(self) -> List:
        if not self.serving_policies:
            return []
        from .serving import ServingCell, ServingPool, ServingWorkload
        wls = self.serving_workloads or (ServingWorkload(),)
        pools = self.serving_pools or (ServingPool(),)
        if isinstance(self.arrivals, Mapping):
            raise ValueError("serving cells need a flat arrival list, "
                             "not a per-workload mapping")
        return [ServingCell(p, w, a, sp)
                for p in self.serving_policies
                for w in wls
                for a in self.arrivals
                for sp in pools]

    def _drift_cells(self) -> List:
        if not self.drift_programs:
            return []
        from .drift import DriftCell
        return [DriftCell(s, p, z)
                for s in self.schemes
                for p in self.drift_programs
                for z in self.ssd_zone_budgets]

    def cells(self) -> List[Union[ScenarioCell, MultiTenantCell]]:
        if self.tenants:
            return [MultiTenantCell(s, tuple(mix), pol, z, f)
                    for s in self.schemes
                    for mix in self.tenants
                    for pol in self.policies
                    for z in self.ssd_zone_budgets
                    for f in self.faults] \
                + self._serving_cells() + self._drift_cells()
        return [ScenarioCell(s, w, a, z, f, fb, nsh, self.routing, rb)
                for s in self.schemes
                for w in map(self._workload_spec, self.workloads)
                for a in self._arrivals_of(w)
                for z in self.ssd_zone_budgets
                for f in self.faults
                for fb in self.filter_bits
                for nsh in self.shards
                for rb in (self.rebalance if nsh > 1 else (False,))
                ] + self._serving_cells() + self._drift_cells()

    def _fresh_db(self, scheme: str, ssd_zones: int,
                  filter_bits: Optional[int] = None, shards: int = 1,
                  routing: str = "hash", rebalance: bool = False):
        if self.db_factory is not None:
            # factories only need to understand the sweep kwargs the
            # matrix actually exercises (GridDBFactory takes them all) —
            # defaults are omitted so plain (scheme, zones) factories
            # keep working
            kw = {}
            if filter_bits is not None:
                kw["filter_bits"] = filter_bits
            if shards > 1:
                kw.update(shards=shards, routing=routing,
                          rebalance=rebalance)
            return self.db_factory(scheme, ssd_zones, **kw)
        from dataclasses import replace as _replace
        from ..lsm import DB, ScenarioConfig
        sc = ScenarioConfig(ssd_zones=ssd_zones)
        if filter_bits is not None:
            sc = _replace(sc, lsm=_replace(
                sc.lsm, filter_bits_per_key=int(filter_bits)))
        n_keys = sc.paper_keys // self.key_div
        if shards > 1:
            from ..cluster import ShardedDB
            db = ShardedDB(scheme, sc, shards=shards, routing=routing,
                           key_space=n_keys, rebalance=rebalance,
                           torch_device=self.torch_device)
        else:
            db = DB(scheme, sc, torch_device=self.torch_device)
        run_load(db, n_keys=n_keys)
        db.flush_all()
        db.n_keys = n_keys
        return db

    def run_cell(self, cell: Union[ScenarioCell, MultiTenantCell]
                 ) -> Tuple[List[OpenLoopResult], List[Dict]]:
        """Run one fully-resolved cell on a freshly loaded store.

        A cell's outcome depends only on the cell spec and the matrix's
        sizing/seed fields — never on other cells — which is what lets the
        sweep driver (``repro_torch.workloads.sweep``) shard cells across
        worker processes and still produce rows identical to a sequential
        run.
        Returns the per-(sub)run results plus their JSON rows (one per
        tenant for multi-tenant cells, else exactly one).
        """
        from .drift import DriftCell, run_drift
        from .serving import ServingCell, run_matrix_cell
        if isinstance(cell, ServingCell):
            return run_matrix_cell(self, cell)
        n_shards = getattr(cell, "shards", 1)
        db = self._fresh_db(cell.scheme, cell.ssd_zones,
                            getattr(cell, "filter_bits", None),
                            shards=n_shards,
                            routing=getattr(cell, "routing", "hash"),
                            rebalance=getattr(cell, "rebalance", False))
        n_keys = getattr(db, "n_keys",
                         db.scenario.paper_keys // self.key_div)
        # sharded cells: baseline the router counters after the load phase
        # so per-shard rows report the measured run only
        kv_snap = db.kv.snapshot() if n_shards > 1 else None
        reg = None
        if self.telemetry or self.timeline_dir is not None:
            period = (float(self.telemetry)
                      if not isinstance(self.telemetry, bool)
                      and self.telemetry else 5.0)
            reg = db.enable_telemetry(period)
        if isinstance(cell, MultiTenantCell):
            res = run_multi_tenant(
                db, list(cell.tenants), self.duration, n_keys=n_keys,
                warmup=self.warmup,
                max_concurrency=self.max_concurrency,
                seed=self.seed, policy=cell.policy, faults=cell.fault)
            per_cell = res.tenants
        elif isinstance(cell, DriftCell):
            per_cell = run_drift(
                db, cell.program, n_keys=n_keys, warmup=self.warmup,
                max_concurrency=self.max_concurrency, seed=self.seed)
        else:
            per_cell = [run_open_loop(
                db, cell.workload, cell.arrival, self.duration,
                n_keys=n_keys, warmup=self.warmup,
                max_concurrency=self.max_concurrency, seed=self.seed,
                read_batch=self.read_batch, faults=cell.fault)]
        if reg is not None:
            reg.sample_now()        # close the series at end-of-run state
            if self.timeline_dir is not None:
                from ..obs.metrics import timeline_path
                meta = {"cell": cell.name, "scheme": cell.scheme,
                        "ssd_zones": cell.ssd_zones}
                if isinstance(cell, DriftCell):
                    # phase windows (relative virtual s) so timeline
                    # plots can segment by phase alongside the marks
                    meta["drift"] = cell.program.name
                    meta["phases"] = [
                        {"name": p.name, "t0": b[0], "t1": b[1]}
                        for p, b in zip(cell.program.phases,
                                        cell.program.bounds())]
                reg.dump_timeline(
                    timeline_path(self.timeline_dir, cell.name), meta=meta)
        rows = []
        for r in per_cell:
            row = r.to_json()
            row["ssd_zones"] = cell.ssd_zones
            row["cell"] = cell.name
            fb = getattr(cell, "filter_bits", None)
            if fb is not None:
                row["filter_bits"] = fb
            if n_shards > 1:
                calls0, routed0, _ = kv_snap
                calls1, routed1, _ = db.kv.snapshot()
                row["shards"] = n_shards
                row["routing"] = cell.routing
                row["rebalance"] = cell.rebalance
                row["kv_calls"] = calls1 - calls0
                row["shard_ops"] = {
                    str(i): routed1[i] - routed0[i]
                    for i in range(n_shards)}
                row["splits"] = [dict(s) for s in db.splits]
            rows.append(row)
        if n_shards > 1:
            # per-shard sub-rows share the cell name (aggregate row is
            # the one WITHOUT a "shard" column)
            for srow in db.shard_stats(kv_snap):
                srow.update(cell=cell.name, scheme=cell.scheme,
                            ssd_zones=cell.ssd_zones, shards=n_shards,
                            routing=cell.routing,
                            rebalance=cell.rebalance)
                rows.append(srow)
        return per_cell, rows

    def run(self, out: Optional[Union[str, Path]] = None,
            verbose: bool = True) -> List[Dict]:
        rows: List[Dict] = []
        for cell in self.cells():
            per_cell, cell_rows = self.run_cell(cell)
            self.results.extend(per_cell)
            rows.extend(cell_rows)
            if verbose:
                for r in per_cell:
                    print(r.row(), flush=True)
        if out is not None:
            out = Path(out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(rows, indent=1))
        return rows
