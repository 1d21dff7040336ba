"""Phase-programmed drift traces: deterministic non-stationary workloads.

Every other scenario family drives the store with a *stationary*
key-popularity process, so the paper scheme's hinted caching and §3.4-3.5
popularity/capacity migration are never stress-tested in the regimes where
they could lose: drifting hotspots, growing working sets, and tenants that
arrive and depart mid-run.  This module adds the missing axis:

* A :class:`TraceProgram` is an ordered list of :class:`Phase`\\ s pinned to
  virtual-time boundaries.  Each phase overrides the op mix and key chooser
  (via a full ``WorkloadSpec`` — Zipf with a per-phase reseeded rank
  rotation, the contiguous ``hotspot`` walk on a *virtual-time* schedule,
  or ``latest``), the working-set size (keyspace growth between phases),
  scan-burst injection (a fraction of the phase's ops become long scans —
  an analytical phase), and the live tenant set (departing tenants drain
  in-flight ops against a deadline; arriving tenants get fresh seeded
  ``OpStream``\\ s).
* :func:`run_drift` executes a program against one store with the same
  bounded server pool / queueing-vs-service decomposition as
  ``run_open_loop``, and reports **per-phase metric windows**: each
  per-tenant row carries a ``phases`` column with per-phase throughput and
  queueing/service p99 (an op straddling a boundary is counted in exactly
  one window — the phase it *arrived* in).
* :func:`phase_rankings` / :func:`rank_flips` compare schemes' per-phase
  throughput across rows of a sweep and count the phase transitions where
  the scheme ordering changes — the run-level ``rank_flips`` summary the
  published drift family carries.

Determinism contract: all arrival timestamps and op streams are generated
up front from seeds derived only from ``(seed, tenant index, phase
index)`` — never from execution state — so the same program yields
byte-identical op sequences across schemes, sweep worker counts, and
telemetry settings (asserted by ``tests/test_torch_control.py`` and the CI
grid-smoke drift leg).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .runner import (ArrivalProcess, BurstyArrivals, OpenLoopResult,
                     PoissonArrivals)
from .ycsb import (READ, SCAN, OpStream, Ops, WorkloadSpec, YCSB, _pct,
                   collect_extras)


# ======================================================================
# program schema
# ======================================================================
@dataclass(frozen=True)
class Phase:
    """One virtual-time window of a :class:`TraceProgram`.

    ``workload`` (a YCSB letter or full ``WorkloadSpec``) is the phase's
    default op mix + key chooser; ``per_tenant`` overrides it for named
    tenants.  ``n_keys`` overrides the working-set size for this phase
    (keyspace growth: choosers span the larger range, reads beyond the
    loaded set miss — cheap under Bloom filters, exactly like a freshly
    grown keyspace).  ``scan_burst`` rewrites that fraction of the
    phase's ops into ``scan_len``-long scans (seeded, pre-generated).
    ``tenants`` restricts the live tenant set (``None`` = all program
    tenants live).
    """

    name: str
    duration: float                       # virtual seconds
    workload: Union[str, WorkloadSpec]
    per_tenant: Tuple[Tuple[str, Union[str, WorkloadSpec]], ...] = ()
    n_keys: int = 0                       # 0 = the program/runner default
    scan_burst: float = 0.0               # fraction of ops becoming scans
    scan_len: int = 200
    tenants: Optional[Tuple[str, ...]] = None


@dataclass(frozen=True)
class DriftTenant:
    """A named tenant of a program with its own arrival process.  The
    tenant's *index in the program* (not the live set) seeds its streams,
    so adding/removing other tenants never reshuffles its ops."""

    name: str
    arrival: ArrivalProcess


@dataclass(frozen=True)
class TraceProgram:
    """An ordered, virtual-time-pinned sequence of phases over a fixed
    tenant table.  Frozen + built from frozen parts, so ``DriftCell``\\ s
    pickle into sweep workers unchanged."""

    name: str
    phases: Tuple[Phase, ...]
    tenants: Tuple[DriftTenant, ...]
    n_keys: int = 0                       # 0 = the runner's n_keys
    # departing tenants: ops queued at the departure boundary are dropped
    # there; ops already in service must complete within this deadline
    # (violations are counted on the row and asserted zero by tests)
    drain_s: float = 30.0

    @property
    def duration(self) -> float:
        return float(sum(p.duration for p in self.phases))

    def bounds(self) -> List[Tuple[float, float]]:
        """Relative [t0, t1) virtual-time window of every phase."""
        out, t = [], 0.0
        for p in self.phases:
            out.append((t, t + p.duration))
            t += p.duration
        return out

    def live_in(self, phase: Phase, tenant: str) -> bool:
        return phase.tenants is None or tenant in phase.tenants

    def spec_for(self, phase: Phase, tenant: str) -> WorkloadSpec:
        w = dict(phase.per_tenant).get(tenant, phase.workload)
        return YCSB[w] if isinstance(w, str) else w


def inject_scan_burst(ops: Ops, frac: float, scan_len: int,
                      rng: np.random.Generator) -> Ops:
    """Rewrite a seeded ``frac`` of pre-generated ops into ``scan_len``-long
    scans, in place — the analytical-phase knob.  Pre-generation keeps the
    rewrite part of the deterministic op sequence."""
    if frac <= 0.0:
        return ops
    mask = rng.random(len(ops.codes)) < frac
    ops.codes[mask] = SCAN
    ops.scan_lens[mask] = scan_len
    return ops


# ======================================================================
# the engine
# ======================================================================
@dataclass
class _Slice:
    """One (tenant x live phase) pre-generated arrival/op slice."""

    ti: int
    k: int
    rel: np.ndarray                       # absolute-relative arrival times
    stream: OpStream


def run_drift(db, program: TraceProgram, *, n_keys: int = 0,
              warmup: float = 0.0, max_concurrency: int = 64,
              seed: int = 1) -> List[OpenLoopResult]:
    """Run a phase-programmed drift trace; one ``OpenLoopResult`` per
    program tenant, each carrying ``drift``/``phases`` columns.

    Every (tenant x live-phase) pair gets its own arrival-time array and
    fresh seeded ``OpStream`` (seeds stride by tenant *and* phase index),
    generated before the first event fires — the op sequence is a pure
    function of ``(program, n_keys, seed)``.  The merged arrival stream
    feeds one bounded pool of ``max_concurrency`` servers, exactly like
    ``run_multi_tenant`` without admission control.

    Phase-window accounting assigns each op to the phase it *arrived* in
    (a boundary straddler counts in exactly one window); per tenant,
    ``sum(phase n_arrived) == n_arrived`` and
    ``n_arrived == n_completed + dropped`` (``drain=True`` semantics:
    everything still live at end-of-program completes).

    Tenant departure (live in phase k-1, absent from phase k): arrivals
    stop at the boundary by construction; ops still *queued* there are
    dropped at the boundary (counted in ``dropped``, never executed); ops
    already in service drain, and any that complete after
    ``boundary + program.drain_s`` count as ``drain_violations``.
    """
    sim = db.sim
    tenants = program.tenants
    if not tenants:
        raise ValueError(f"program {program.name!r} has no tenants")
    names = [t.name for t in tenants]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names: {names}")
    if not program.phases:
        raise ValueError(f"program {program.name!r} has no phases")
    phases = program.phases
    bounds = program.bounds()
    total = bounds[-1][1]

    # ---- pre-generate every (tenant x live phase) slice -------------
    slices: List[_Slice] = []
    for ti, ten in enumerate(tenants):
        for k, ph in enumerate(phases):
            if not program.live_in(ph, ten.name):
                continue
            spec = program.spec_for(ph, ten.name)
            pk = ph.n_keys or program.n_keys or n_keys
            if pk <= 0:
                raise ValueError("run_drift needs n_keys (argument, "
                                 "program, or phase override)")
            rng = np.random.default_rng(seed + 2 + 9973 * ti + 101 * k)
            rel = bounds[k][0] + ten.arrival.times(rng, ph.duration)
            stream = OpStream(db, spec, n_ops=len(rel), n_keys=pk,
                              seed=seed + 9973 * ti + 101 * k)
            # write attribution: flushed bytes tag back to the tenant
            stream.tenant = ten.name
            inject_scan_burst(
                stream.ops, ph.scan_burst, ph.scan_len,
                np.random.default_rng(seed + 5 + 9973 * ti + 101 * k))
            slices.append(_Slice(ti=ti, k=k, rel=rel, stream=stream))

    m_at = (np.concatenate([s.rel for s in slices])
            if slices else np.empty(0, np.float64))
    m_si = np.concatenate([np.full(len(s.rel), si, np.int64)
                           for si, s in enumerate(slices)]) \
        if slices else np.empty(0, np.int64)
    m_i = np.concatenate([np.arange(len(s.rel), dtype=np.int64)
                          for s in slices]) \
        if slices else np.empty(0, np.int64)
    order = np.argsort(m_at, kind="stable")   # ties: tenant/phase order
    m_at, m_si, m_i = m_at[order], m_si[order], m_i[order]
    m = len(m_at)

    t0 = sim.now
    arrive = [np.full(len(s.rel), np.nan) for s in slices]
    start = [np.full(len(s.rel), np.nan) for s in slices]
    done = [np.full(len(s.rel), np.nan) for s in slices]
    dropped = [np.zeros(len(s.rel), bool) for s in slices]
    queue: deque = deque()
    idle: List = []                       # events of parked servers
    depth = [0] * len(tenants)            # per-tenant ops in queue
    tmax_depth = [0] * len(tenants)
    state = {"closed": False, "max_depth": 0, "next": 0}

    # departure boundaries: tenants live in phase k-1 but not in phase k
    departures: List[Tuple[float, int, frozenset]] = []
    for k in range(1, len(phases)):
        prev_live = {t.name for t in tenants
                     if program.live_in(phases[k - 1], t.name)}
        now_live = {t.name for t in tenants
                    if program.live_in(phases[k], t.name)}
        gone = prev_live - now_live
        if gone:
            departures.append((bounds[k][0], k, frozenset(gone)))

    # phase-boundary markers on the telemetry bus (pull-only: marks are
    # recorded via daemon timeouts and never perturb the event schedule)
    reg = getattr(db, "metrics", None)
    if reg is not None and hasattr(reg, "mark"):
        def marker():
            for k, (b0, _b1) in enumerate(bounds):
                at = t0 + b0
                if at > sim.now:
                    yield sim.timeout(at - sim.now, daemon=True)
                reg.mark(f"phase:{phases[k].name}")
        sim.process(marker())

    def dispatcher():
        while state["next"] < m:
            j = state["next"]
            at = t0 + float(m_at[j])
            if at > sim.now:
                yield at - sim.now   # bare-delay: no Event
            si, i = int(m_si[j]), int(m_i[j])
            arrive[si][i] = sim.now
            state["next"] = j + 1
            ti = slices[si].ti
            queue.append((si, i))
            depth[ti] += 1
            if depth[ti] > tmax_depth[ti]:
                tmax_depth[ti] = depth[ti]
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
            si, i = queue.popleft()
            depth[slices[si].ti] -= 1
            start[si][i] = sim.now
            yield from slices[si].stream.execute(i)
            done[si][i] = sim.now

    def reaper(at_rel: float, k: int, gone: frozenset):
        # departure boundary: cancel the departed tenants' queued (not
        # yet started) ops; in-service ops drain toward the deadline
        at = t0 + at_rel
        if at > sim.now:
            yield at - sim.now   # bare-delay: no Event
        kept = deque()
        while queue:
            si, i = queue.popleft()
            if names[slices[si].ti] in gone and slices[si].k < k:
                dropped[si][i] = True
                depth[slices[si].ti] -= 1
            else:
                kept.append((si, i))
        queue.extend(kept)

    procs = [db.submit(server()) for _ in range(max_concurrency)]
    procs.append(db.submit(dispatcher()))
    for at_rel, k, gone in departures:
        procs.append(sim.process(reaper(at_rel, k, gone)))
    for p in procs:
        sim.run_until(p)
    busy_span = max(sim.now - t0, 1e-12)

    # ---- per-tenant, per-phase accounting ---------------------------
    extras = collect_extras(db)
    results: List[OpenLoopResult] = []
    for ti, ten in enumerate(tenants):
        mine = [si for si, s in enumerate(slices) if s.ti == ti]
        arr = np.concatenate([arrive[si] for si in mine])
        st = np.concatenate([start[si] for si in mine])
        dn = np.concatenate([done[si] for si in mine])
        drp = np.concatenate([dropped[si] for si in mine])
        completed = ~np.isnan(dn)
        measured = completed & (arr - t0 >= warmup)
        lat = dn - arr
        qdel = st - arr
        serv = dn - st
        codes = np.concatenate([slices[si].stream.ops.codes for si in mine]) \
            if mine else np.empty(0, np.int8)
        reads = (codes == READ) & measured

        phase_rows: List[Dict] = []
        for si in mine:
            s = slices[si]
            b0, b1 = bounds[s.k]
            c = ~np.isnan(done[si])
            mz = c & (arrive[si] - t0 >= warmup)
            tt = done[si] - arrive[si]
            qq = start[si] - arrive[si]
            vv = done[si] - start[si]
            phase_rows.append({
                "phase": s.k, "name": phases[s.k].name,
                "t0": b0, "t1": b1,
                "workload": s.stream.spec.name,
                "n_arrived": int(len(arrive[si])),
                "n_completed": int(c.sum()),
                "n_dropped": int(dropped[si].sum()),
                "n_measured": int(mz.sum()),
                "throughput": float(c.sum()) / max(b1 - b0, 1e-12),
                "latency_p99": _pct(tt[mz])["p99"],
                "queue_p99": _pct(qq[mz])["p99"],
                "service_p99": _pct(vv[mz])["p99"],
            })

        violations = 0
        for at_rel, k, gone in departures:
            if ten.name not in gone:
                continue
            deadline = t0 + at_rel + program.drain_s
            for si in mine:
                if slices[si].k < k:
                    d = done[si]
                    violations += int((d[~np.isnan(d)] > deadline).sum())

        counts: Dict[str, int] = {}
        for si in mine:
            for op, c in slices[si].stream.counts.items():
                counts[op] = counts.get(op, 0) + c
        results.append(OpenLoopResult(
            name=program.name, scheme=db.scheme, arrival=ten.arrival.name,
            n_arrived=int(len(arr)), n_measured=int(measured.sum()),
            duration=total,
            offered_rate=len(arr) / max(total, 1e-12),
            throughput=float(completed.sum()) / busy_span,
            latency_p=_pct(lat[measured]), queue_p=_pct(qdel[measured]),
            service_p=_pct(serv[measured]),
            read_latency_p=_pct(lat[reads]),
            mean_latency=float(lat[measured].mean()) if measured.any() else 0.0,
            mean_queue=float(qdel[measured].mean()) if measured.any() else 0.0,
            mean_service=float(serv[measured].mean()) if measured.any() else 0.0,
            max_queue_depth=tmax_depth[ti],
            op_counts=counts, extras=extras,
            tenant=ten.name, drift=program.name, phases=phase_rows,
            n_completed=int(completed.sum()), dropped=int(drp.sum()),
            drain_violations=violations))
    return results


# ======================================================================
# cross-scheme per-phase rankings
# ======================================================================
def phase_rankings(rows: Sequence[Dict], metric: str = "latency_p99"
                   ) -> Dict[Tuple, Dict]:
    """Rank schemes by per-phase ``metric`` across drift rows.

    The default metric is the in-window sojourn tail (``latency_p99``,
    lower is better): because every op is scored in the phase it
    *arrived* in and the run drains to completion, per-phase
    *throughput* is arrival-bound by construction — identical across
    schemes except for drops — so tails are the quantity that actually
    discriminates.  ``metric="throughput"`` is still accepted (higher is
    better) for drop-heavy programs.

    Rows are grouped by ``(drift program, arrival, tenant, ssd_zones)`` —
    everything but the scheme — and within each group every phase gets a
    scheme ordering (best first; ties broken by scheme name for
    determinism; schemes with no measured op in the window are excluded
    rather than ranked on an empty percentile).  Returns ``{group:
    {"phases": [{"phase", "name", "ranking", <metric>}...], "flips": n}}``
    where ``flips`` counts the phase transitions whose ordering differs
    from the previous phase — the run-level non-stationarity summary.
    """
    lower_is_better = metric != "throughput"
    groups: Dict[Tuple, List[Dict]] = {}
    for r in rows:
        if "drift" not in r or "phases" not in r:
            continue
        key = (r["drift"], r.get("arrival"), r.get("tenant"),
               r.get("ssd_zones"))
        groups.setdefault(key, []).append(r)
    out: Dict[Tuple, Dict] = {}
    for key in sorted(groups, key=str):
        per_phase: Dict[int, List[Tuple[str, float]]] = {}
        pnames: Dict[int, str] = {}
        for r in groups[key]:
            for p in r["phases"]:
                if lower_is_better and not p.get("n_measured", 1):
                    continue
                per_phase.setdefault(p["phase"], []).append(
                    (r["scheme"], float(p[metric])))
                pnames[p["phase"]] = p["name"]
        phases_out: List[Dict] = []
        prev = None
        flips = 0
        for k in sorted(per_phase):
            vals = per_phase[k]
            sign = 1.0 if lower_is_better else -1.0
            ranking = [s for s, _v in
                       sorted(vals, key=lambda sv: (sign * sv[1], sv[0]))]
            if prev is not None and ranking != prev:
                flips += 1
            prev = ranking
            phases_out.append({"phase": k, "name": pnames[k],
                               "ranking": ranking,
                               metric: dict(sorted(vals))})
        out[key] = {"phases": phases_out, "flips": flips}
    return out


def rank_flips(rows: Sequence[Dict], metric: str = "latency_p99"
               ) -> Dict[Tuple, int]:
    """Per group (see :func:`phase_rankings`), the number of phase
    boundaries where the scheme ordering by ``metric`` changed."""
    return {k: v["flips"] for k, v in phase_rankings(rows, metric).items()}


# ======================================================================
# named programs
# ======================================================================
def _arrival(kind: str, rate: float, phase_s: float) -> ArrivalProcess:
    """Arrival shapes for drift tenants, anchored to a calibrated rate —
    the burst period scales with the phase length so every phase sees
    full on/off cycles."""
    if kind == "poisson":
        return PoissonArrivals(round(rate, 4))
    if kind == "bursty":
        return BurstyArrivals(round(0.4 * rate, 4), round(2.5 * rate, 4),
                              on=round(0.12 * phase_s, 4),
                              off=round(0.28 * phase_s, 4))
    raise ValueError(f"unknown drift arrival kind {kind!r}; "
                     f"one of ('poisson', 'bursty')")


def _rotate(*, svc: float, n_keys: int, arrival_kind: str,
            phase_s: float) -> TraceProgram:
    """Single-tenant chooser rotation: skewed reads -> virtual-time
    hotspot walk -> scan-burst analytics -> working-set growth.  Each
    phase reseeds the Zipf rank scramble, so the hot *keys* rotate at
    every boundary even where the mix does not change."""
    tenants = (DriftTenant("t0", _arrival(arrival_kind, 0.45 * svc,
                                          phase_s)),)
    readmix = WorkloadSpec("readmix", read=0.9, update=0.1, alpha=0.99)
    shift = WorkloadSpec("shift", read=0.8, update=0.2, dist="hotspot",
                         alpha=0.99, hotspot_step="auto",
                         hotspot_period_s=round(phase_s / 5.0, 4))
    grow = WorkloadSpec("grow", read=0.6, insert=0.4, dist="latest",
                        alpha=0.9)
    phases = (
        Phase("warm", phase_s, readmix),
        Phase("shift", phase_s, shift),
        Phase("analytics", phase_s, readmix, scan_burst=0.25, scan_len=200),
        Phase("grow", phase_s, grow, n_keys=int(1.5 * n_keys)),
    )
    return TraceProgram(f"rotate~{arrival_kind}", phases, tenants,
                        n_keys=n_keys)


def _churn(*, svc: float, n_keys: int, arrival_kind: str,
           phase_s: float) -> TraceProgram:
    """Tenant churn: a persistent read-heavy tenant, plus a write/scan
    batch tenant that arrives for the middle phase and departs (its
    queued ops are dropped at the boundary, in-service ops drain)."""
    tenants = (
        DriftTenant("base", _arrival(arrival_kind, 0.35 * svc, phase_s)),
        DriftTenant("batch", _arrival("poisson", 0.5 * svc, phase_s)),
    )
    readmix = WorkloadSpec("readmix", read=0.9, update=0.1, alpha=0.99)
    batchmix = WorkloadSpec("batchmix", update=0.6, scan=0.2, insert=0.2,
                            alpha=0.9, scan_max=60)
    phases = (
        Phase("solo", phase_s, readmix, tenants=("base",)),
        Phase("contend", phase_s, readmix,
              per_tenant=(("batch", batchmix),),
              tenants=("base", "batch")),
        Phase("after", phase_s, readmix, tenants=("base",)),
    )
    return TraceProgram(f"churn~{arrival_kind}", phases, tenants,
                        n_keys=n_keys)


PROGRAM_BUILDERS = {"rotate": _rotate, "churn": _churn}


def build_program(name: str, *, svc: float, n_keys: int,
                  arrival_kind: str = "poisson",
                  phase_s: float = 150.0) -> TraceProgram:
    """Instantiate a named program against a calibrated service rate.
    The program name encodes the arrival kind (``rotate~poisson``), so
    one sweep can carry both arrival variants as distinct cells."""
    try:
        builder = PROGRAM_BUILDERS[name]
    except KeyError:
        raise ValueError(f"unknown drift program {name!r}; "
                         f"one of {sorted(PROGRAM_BUILDERS)}") from None
    return builder(svc=svc, n_keys=n_keys, arrival_kind=arrival_kind,
                   phase_s=phase_s)


# ======================================================================
# sweep integration
# ======================================================================
@dataclass(frozen=True)
class DriftCell:
    """One fully-resolved drift cell: a program on one scheme/SSD budget.
    The run's duration is the program's own (``TraceProgram.duration``),
    not the matrix default."""

    scheme: str
    program: TraceProgram
    ssd_zones: int

    @property
    def name(self) -> str:
        return f"{self.scheme}/drift:{self.program.name}/z{self.ssd_zones}"
