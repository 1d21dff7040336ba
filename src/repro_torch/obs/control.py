"""Control plane v2: telemetry-driven feedback over the store's knobs.

Closes the ROADMAP "control plane v2" item on top of the metrics bus.
Three mechanisms, all keyed on signals the registry already samples:

* **Debt pressure** — ``AdmissionConfig.debt_threshold`` makes compaction
  debt (bytes of level overflow, the governing backpressure quantity of
  LSM write amplification) a *third* admission pressure signal next to
  WAL stalls and service backlog: the controller's ``debt_gauge`` is
  consulted by ``AdmissionController.under_pressure()``, so the static
  ``reject``/``delay`` policies shed *before* the debt turns into write
  stalls.  That wiring lives in the middleware; no ControlPlane needed.

* **SLO feedback** — under policy ``"feedback"`` the admission
  controller runs per-tenant token buckets whose rates are *driven*, not
  configured.  Two pluggable control laws
  (``AdmissionConfig.feedback_controller``):

  - ``"aimd"`` (default, the first feedback loop unchanged): multiplicative
    decrease while any protected tenant misses its ``TenantSpec.slo_p99``
    target *or* compaction debt exceeds the threshold, additive increase
    while every target has headroom.
  - ``"pi"``: a proportional-integral law (:class:`PIController`) on the
    worst protected p99/target ratio — EWMA-smoothed, blended with the
    continuous debt/threshold ratio — with conditional-integration
    anti-windup, emitting one smooth admission multiplier ``u`` in
    ``[feedback_floor, 1]`` instead of AIMD's sawtooth.  Per-tenant
    **debt attribution** (``LSMTree.debt_by_tenant``, the flush ->
    compaction lineage) biases the multiplier: the tenant generating the
    larger share of the compaction debt is throttled harder
    (``u ** (1 + share)``), so the controller targets the debt
    *generator* instead of penalizing all non-protected tenants
    uniformly.

* **Auxiliary knobs** — with a ``db`` binding, ``feedback_knobs`` extends
  actuation beyond admission (SILK-style: schedule internal LSM work,
  don't just shed load).  All knobs derive from the same actuation level
  ``u`` (AIMD tracks an equivalent aggregate), so one pressure signal
  steers the whole store:

  - ``"compaction"``: ``LSMTree.compaction_pace`` — background
    compaction I/O beyond L0 is stretched by ``1/pace``, deferring debt
    work while foreground pressure is high and draining it in lulls.
  - ``"migration"``: scales ``Migrator.rate_limit`` around its
    configured base — aggressive data movement in lulls, out of the way
    under pressure.
  - ``"cache"``: the backend's ``cache_zone_budget`` — shrinks the
    hinted cache's zone footprint under write pressure so reserved SSD
    zones serve the WAL, restores it when reads dominate.

The plane is a daemon process on the DES clock: control actions happen
in virtual time, reproducibly.  It also publishes its own signals into
the registry (``ctl.*``: measured p99 per SLO tenant, targets,
instantaneous attainment, the driven rates, and the knob trajectory
``ctl.u`` / ``ctl.knob.*``), so timeline artifacts show the feedback
loop converging.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from .metrics import Ewma

# actuators the control plane can drive (AdmissionConfig.feedback_knobs)
KNOBS = ("admission", "compaction", "migration", "cache")

# knob shaping constants: compaction pace floor (never stall debt work
# entirely — SILK drains in lulls, it doesn't stop), migration scale range
# around the configured base rate, and the actuation level above which the
# cache budget is released back to "unlimited"
PACE_FLOOR = 0.3
# fraction of the debt threshold at which the pace floor reaches 1.0:
# deferral is a low-debt luxury — above half the threshold the drain
# always runs at full speed (slowing it there just extends the degraded
# phase it is meant to relieve)
PACE_DEBT_GATE = 0.5
MIGRATION_SCALE = (0.25, 1.5)
CACHE_RELEASE_U = 0.9


class PIController:
    """Discrete proportional-integral law with anti-windup.

    ``update(measurement, dt)`` returns the actuation ``u`` clamped to
    ``[lo, hi]`` for error ``e = setpoint - measurement``::

        u = u0 + kp * e + ki * integral,   integral += e * dt

    Anti-windup is conditional integration: the integral is frozen
    whenever the *unsaturated* output is already past a clamp and the
    error would push it further — without this, a long overload winds the
    integral arbitrarily negative and the controller stays pinned at the
    floor long after the pressure clears (the classic windup lag;
    asserted by ``tests/test_torch_control.py``).
    """

    def __init__(self, kp: float, ki: float, setpoint: float = 1.0,
                 lo: float = 0.0, hi: float = 1.0, u0: float = 1.0):
        if lo >= hi:
            raise ValueError(f"need lo < hi, got [{lo}, {hi}]")
        self.kp = float(kp)
        self.ki = float(ki)
        self.setpoint = float(setpoint)
        self.lo = float(lo)
        self.hi = float(hi)
        self.u0 = float(u0)
        self.integral = 0.0
        self.last_u = min(max(self.u0, self.lo), self.hi)

    def update(self, measurement: float, dt: float) -> float:
        e = self.setpoint - float(measurement)
        u_unsat = self.u0 + self.kp * e + self.ki * self.integral
        sat_hi = u_unsat >= self.hi and e > 0.0
        sat_lo = u_unsat <= self.lo and e < 0.0
        if not (sat_hi or sat_lo):
            self.integral += e * float(dt)
        u = self.u0 + self.kp * e + self.ki * self.integral
        self.last_u = min(max(u, self.lo), self.hi)
        return self.last_u

    def reset(self) -> None:
        self.integral = 0.0
        self.last_u = min(max(self.u0, self.lo), self.hi)


class ControlPlane:
    """Feedback from measured per-tenant p99 to the store's knobs.

    ``ctrl`` is the run's ``AdmissionController`` (policy ``feedback``);
    ``targets`` maps tenant name -> sojourn p99 target in virtual seconds
    (from ``TenantSpec.slo_p99``).  Tenants in ``ctrl.cfg.protected`` are
    never throttled — the plane drives every *other* tenant's rate.
    Feedback constants live on ``AdmissionConfig`` (``feedback_*``) so a
    scenario cell stays a single picklable spec.

    ``db`` (optional) binds the plane to the store for the non-admission
    knobs and for per-tenant debt attribution; actuator targets (the
    tree, the migrator, the backend) are re-resolved through it on every
    tick, so a ``DB.reopen()`` that swaps the tree rebinds automatically.
    Without ``db`` the plane is exactly the v1 admission-only loop.
    """

    def __init__(self, sim, ctrl, targets: Dict[str, float],
                 debt_gauge: Optional[Callable[[], float]] = None,
                 registry=None, db=None):
        self.sim = sim
        self.ctrl = ctrl
        self.db = db
        self.targets = {t: float(v) for t, v in targets.items() if v}
        self.debt_gauge = debt_gauge
        self._lat: Dict[str, deque] = {}
        self._p99: Dict[str, float] = {}
        # base rate per controlled tenant: anchors the additive step and
        # the floor.  Configured finite rates anchor directly; an infinite
        # (unconfigured) rate is anchored to the measured admit rate at
        # the first decrease.
        self._base: Dict[str, float] = {}
        self._admitted_prev: Dict[str, float] = {}
        self.adjustments = {"decrease": 0, "increase": 0, "hold": 0}
        self._alive = True
        cfg = ctrl.cfg
        # aggregate actuation level in [0, 1]: the PI law's output, or an
        # AIMD-tracked equivalent; 1.0 = no throttling.  Drives the
        # auxiliary knobs for both control laws.
        self._u = 1.0
        self._filter = Ewma(alpha=cfg.feedback_smooth)
        self._pi = PIController(cfg.feedback_kp, cfg.feedback_ki,
                                setpoint=1.0,
                                lo=max(float(cfg.feedback_floor), 0.0),
                                hi=1.0)
        self._mig_base: Optional[float] = None
        # last applied knob values, for telemetry/rows (cache budget -1.0
        # means "unlimited")
        self.knobs: Dict[str, float] = {
            "pace": 1.0, "migration": 1.0, "cache_budget": -1.0}
        if registry is not None:
            self._install_metrics(registry)

    @property
    def cfg(self):
        # read through to the controller: runners rebind ``ctrl.cfg``
        # (e.g. to widen the protected set for one run)
        return self.ctrl.cfg

    # -- runner-facing hooks --------------------------------------------
    def observe(self, tenant: str, latency: float) -> None:
        """Record one completed op's sojourn (arrival -> done)."""
        lat = self._lat.get(tenant)
        if lat is None:
            lat = self._lat[tenant] = deque(
                maxlen=int(self.cfg.feedback_window))
        lat.append(latency)

    def start(self) -> None:
        # (re)start the daemon loop.  After a DB.crash() the loop died
        # with the store and the admission overrides were cleared by
        # DB.reopen_gen(); the actuation state below is volatile
        # controller memory — reset it so the restarted loop re-derives
        # its trajectory instead of resuming a stale one.
        self._pi.reset()
        self._filter.reset()
        self._u = 1.0
        self._alive = True
        self.sim.process(self._loop())

    def stop(self) -> None:
        """Retire the daemon loop (runs are shorter-lived than the DB)
        and return every auxiliary knob to its *configured* neutral —
        pace 1.0, the migrator's original base rate (not the lull boost),
        unlimited cache — so a later run on the same store starts from
        default actuator state."""
        self._alive = False
        self._restore_neutral()

    def _loop(self):
        while self._alive:
            yield self.sim.timeout(self.cfg.feedback_interval, daemon=True)
            if not self._alive:
                return
            self._tick()

    # -- the controller --------------------------------------------------
    def measured_p99(self, tenant: str) -> Optional[float]:
        return self._p99.get(tenant)

    def attainment(self) -> float:
        """Fraction of SLO tenants currently meeting their target
        (unmeasured tenants count as meeting it)."""
        if not self.targets:
            return 1.0
        met = sum(1 for t, tgt in self.targets.items()
                  if self._p99.get(t, 0.0) <= tgt)
        return met / len(self.targets)

    def debt_over(self) -> bool:
        return (self.cfg.debt_threshold is not None
                and self.debt_gauge is not None
                and self.debt_gauge() > self.cfg.debt_threshold)

    def _configured(self, tenant: str) -> float:
        rates = self.cfg.bucket_rates or {}
        rate, _ = rates.get(tenant,
                            (self.cfg.bucket_rate, self.cfg.bucket_burst))
        return float(rate)

    def _measured_admit_rate(self, tenant: str) -> float:
        c = self.ctrl.counters.get(tenant)
        admitted = float(c["admitted"]) if c else 0.0
        prev = self._admitted_prev.get(tenant, 0.0)
        return max((admitted - prev) / self.cfg.feedback_interval, 1.0)

    def _controlled(self) -> List[str]:
        protected = self.cfg.protected
        return [t for t in self.ctrl.counters if t not in protected]

    def _tick(self) -> None:
        cfg = self.cfg
        worst = 0.0                 # worst p99/target ratio across SLO tenants
        for t, target in self.targets.items():
            lat = self._lat.get(t)
            if lat and len(lat) >= 8:
                p99 = float(np.percentile(np.asarray(lat), 99))
                self._p99[t] = p99
                worst = max(worst, p99 / target)
        # the rolling p99 lags by its window; the controller's *live*
        # pressure signals (service backlog, WAL stalls, compaction debt
        # over threshold) are instantaneous — react to either, so a burst
        # is cut within one control period instead of one window
        over = (worst > 1.0 or self.debt_over()
                or self.ctrl.under_pressure())
        if cfg.feedback_controller == "pi":
            self._tick_pi(worst)
        else:
            self._tick_aimd(worst, over)
        for t in self.ctrl.counters:
            c = self.ctrl.counters[t]
            self._admitted_prev[t] = float(c["admitted"])
        self._apply_knobs(self._u)

    def _tick_aimd(self, worst: float, over: bool) -> None:
        """The first AIMD law, arithmetic unchanged (asserted by
        ``tests/test_torch_control.py``), plus tracking of the aggregate
        actuation level ``_u`` that drives the auxiliary knobs."""
        cfg = self.cfg
        for t in self._controlled():
            cur = self.ctrl.rate_overrides.get(t)
            if cur is None:
                cur = self._configured(t)
            if over:
                # over target (or pressure building): multiplicative
                # decrease
                if not math.isfinite(cur):
                    cur = self._measured_admit_rate(t)
                base = self._base.setdefault(t, cur)
                new = max(cur * cfg.feedback_decrease,
                          cfg.feedback_floor * base)
                self.adjustments["decrease"] += 1
            elif worst < cfg.feedback_headroom and math.isfinite(cur):
                # every target comfortably met (or not yet measurable):
                # additive increase probes capacity back
                base = self._base.setdefault(t, cur)
                new = cur + cfg.feedback_increase * base
                self.adjustments["increase"] += 1
            else:
                self.adjustments["hold"] += 1
                new = cur
            if math.isfinite(new):
                self.ctrl.rate_overrides[t] = new
        if over:
            self._u = max(self._u * cfg.feedback_decrease,
                          float(cfg.feedback_floor))
        elif worst < cfg.feedback_headroom:
            self._u = min(1.0, self._u + cfg.feedback_increase)

    def _tick_pi(self, worst: float) -> None:
        """PI law: one smooth actuation level from the blended pressure
        measurement, biased per tenant by its share of the compaction
        debt (the flush -> compaction attribution lineage)."""
        cfg = self.cfg
        m = worst
        # blend in the *continuous* debt ratio — the PI law can respond
        # proportionally to debt building, where AIMD only sees the
        # threshold crossing
        if cfg.debt_threshold and self.debt_gauge is not None:
            m = max(m, self.debt_gauge() / float(cfg.debt_threshold))
        if self.ctrl.under_pressure():
            m = max(m, 1.25)
        m = self._filter.update(m)
        u = self._pi.update(m, cfg.feedback_interval)
        # asymmetric slew: cuts are immediate, recovery is rate-limited
        # so one good p99 window cannot re-admit a full burst (the PI's
        # own anti-windup keeps its integral from running ahead of the
        # slewed output)
        if cfg.feedback_rise is not None:
            u = min(u, self._u + float(cfg.feedback_rise))
        self._u = u
        shares = self.debt_shares()
        for t in self._controlled():
            base = self._base.get(t)
            if base is None:
                base = self._configured(t)
                if not math.isfinite(base):
                    if u >= 0.999:
                        # unconfigured tenant, no throttling needed yet:
                        # nothing to anchor the multiplier to
                        self.adjustments["hold"] += 1
                        continue
                    base = self._measured_admit_rate(t)
                self._base[t] = base
            # debt-share bias: u**(1+share) < u for the tenant generating
            # the debt, so it absorbs more of the throttling
            ut = u ** (1.0 + shares.get(t, 0.0))
            new = max(ut * base, cfg.feedback_floor * base)
            prev = self.ctrl.rate_overrides.get(t)
            if prev is None or math.isclose(new, prev,
                                            rel_tol=1e-9, abs_tol=1e-12):
                self.adjustments["hold"] += 1
            elif new < prev:
                self.adjustments["decrease"] += 1
            else:
                self.adjustments["increase"] += 1
            self.ctrl.rate_overrides[t] = new

    # -- debt attribution -------------------------------------------------
    def _tree(self):
        db = self.db
        if db is None:
            return None
        return getattr(db, "tree", None)

    def debt_shares(self) -> Dict[str, float]:
        """Controlled tenants' shares of the attributed compaction debt
        (``LSMTree.debt_by_tenant``), normalized over controlled tenants
        only; empty when unattributed or no ``db`` binding."""
        tree = self._tree()
        if tree is None or not hasattr(tree, "debt_by_tenant"):
            return {}
        protected = self.cfg.protected
        by = {t: v for t, v in tree.debt_by_tenant().items()
              if t and t not in protected}
        total = sum(by.values())
        if total <= 0.0:
            return {}
        return {t: v / total for t, v in by.items()}

    # -- auxiliary knobs ---------------------------------------------------
    def _restore_neutral(self) -> None:
        """Put every actuator back to its configured default state."""
        tree = self._tree()
        if tree is not None and hasattr(tree, "compaction_pace"):
            tree.compaction_pace = 1.0
        backend = getattr(self.db, "backend", None) if self.db else None
        if backend is not None:
            if getattr(backend, "migrator", None) is not None \
                    and self._mig_base is not None:
                backend.migrator.rate_limit = self._mig_base
            backend.cache_zone_budget = None
        self.knobs.update(pace=1.0, migration=1.0, cache_budget=-1.0)

    def _apply_knobs(self, u: float) -> None:
        """Map the actuation level onto the enabled non-admission knobs.

        ``u = 1`` means no foreground pressure: pace 1.0 and cache budget
        unlimited (their neutral), and migration at the *top* of its
        scale range — the HHZS lull is exactly when data movement should
        be most aggressive.  Admission-only configurations never touch
        any of these, so they behave exactly like v1."""
        if self.db is None:
            return
        knobs = self.cfg.feedback_knobs
        u = min(max(float(u), 0.0), 1.0)
        if "compaction" in knobs:
            tree = self._tree()
            if tree is not None and hasattr(tree, "compaction_pace"):
                pace = PACE_FLOOR + (1.0 - PACE_FLOOR) * u
                # debt gate: deferral is only free while the backlog is
                # comfortable — the pace floor rises linearly with debt,
                # hitting full speed at PACE_DEBT_GATE of the threshold
                if self.cfg.debt_threshold and self.debt_gauge is not None:
                    ratio = self.debt_gauge() / float(self.cfg.debt_threshold)
                    pace = max(pace, min(ratio / PACE_DEBT_GATE, 1.0))
                tree.compaction_pace = pace
                self.knobs["pace"] = pace
        backend = getattr(self.db, "backend", None)
        if "migration" in knobs and backend is not None \
                and getattr(backend, "migrator", None) is not None:
            mig = backend.migrator
            if self._mig_base is None:
                self._mig_base = float(mig.rate_limit)
            lo, hi = MIGRATION_SCALE
            scale = lo + (hi - lo) * u
            mig.rate_limit = self._mig_base * scale
            self.knobs["migration"] = scale
        if "cache" in knobs and backend is not None \
                and getattr(backend, "cache", None) is not None:
            if u >= CACHE_RELEASE_U:
                backend.cache_zone_budget = None
                self.knobs["cache_budget"] = -1.0
            else:
                pool = max(len(backend.reserve_zids) - 1, 0)
                budget = int(round(u * pool))
                backend.cache_zone_budget = budget
                self.knobs["cache_budget"] = float(budget)

    # -- telemetry -------------------------------------------------------
    def _install_metrics(self, reg) -> None:
        for t, target in self.targets.items():
            reg.gauge(f"ctl.p99.{t}",
                      lambda t=t: self._p99.get(t, 0.0))
            reg.gauge(f"ctl.target.{t}", lambda v=target: v)
        reg.gauge("ctl.attainment", self.attainment)
        reg.gauge("ctl.u", lambda: float(self._u))
        reg.gauge("ctl.knob.pace", lambda: self.knobs["pace"])
        reg.gauge("ctl.knob.migration", lambda: self.knobs["migration"])
        reg.gauge("ctl.knob.cache_budget",
                  lambda: self.knobs["cache_budget"])
        reg.collector(lambda: {
            f"ctl.rate.{t}": v
            for t, v in self.ctrl.rate_overrides.items()
            if math.isfinite(v)}, name="ctl.rates")
        reg.collector(lambda: {
            f"ctl.debt_share.{t}": v
            for t, v in self.debt_shares().items()}, name="ctl.debt_shares")

    def knob_summary(self) -> Dict:
        """JSON-ready knob/controller state for result rows."""
        return {
            "controller": self.cfg.feedback_controller,
            "knobs": list(self.cfg.feedback_knobs),
            "u": float(self._u),
            "pace": float(self.knobs["pace"]),
            "migration": float(self.knobs["migration"]),
            "cache_budget": float(self.knobs["cache_budget"]),
        }

    def summary(self) -> Dict[str, float]:
        """JSON-ready controller accounting for result rows / debugging."""
        out: Dict[str, float] = {
            "decreases": self.adjustments["decrease"],
            "increases": self.adjustments["increase"],
        }
        for t, v in self.ctrl.rate_overrides.items():
            if math.isfinite(v):
                out[f"rate.{t}"] = v
        for t, p in self._p99.items():
            out[f"p99.{t}"] = p
        return out
