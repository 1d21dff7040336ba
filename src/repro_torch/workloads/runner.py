"""Open-loop workload engine: arrival processes and ``run_open_loop``.

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

The reference's multi-tenant runner and scenario matrix
(``run_multi_tenant``, ``ScenarioMatrix``) are not ported yet; the result
row schema (``OpenLoopResult``) is carried over whole, so rows compare
byte for byte with the reference's.

Op semantics are shared with the closed-loop runner via ``OpStream`` —
placement/migration/caching schemes see byte-identical request streams.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..zoned.faults import FaultInjector, FaultSpec
from .ycsb import READ, OpStream, WorkloadSpec, _pct, collect_extras


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
