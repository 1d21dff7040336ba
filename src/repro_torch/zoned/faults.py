"""Fault injection for hybrid zoned storage (crash/recovery evaluation).

ZNS studies (Tehrany & Trivedi, "Understanding NVMe ZNS SSDs") show that
zone-state transitions, resets and device hiccups are exactly where real
deployments break; a reproduction that only models the happy path cannot
validate the paper's WAL-zone organization (§3.2) at all.  This module
declares fault *schedules* and arms them against a running ``DB``:

* ``StallWindow``  — the device freezes for a window: every I/O (foreground
  and background) *submitted* during the window completes only after it
  ends (I/O already in flight keeps its precomputed completion time).
  Models internal garbage collection / firmware stalls.
* ``SlowWindow``   — transient bandwidth degradation: service times are
  multiplied by ``factor`` for I/O submitted inside the window.
* ``ZoneReset``    — the device spontaneously resets one zone (torn zone
  after power loss, firmware bug).  The middleware is notified through
  ``HybridZonedBackend.on_zone_fault`` and must repair: SST zones are
  re-replicated, WAL zones force a flush of their (still memory-resident)
  generations, cache zones drop their mapping entries.
* ``FaultSpec.crash_at`` — full crash + recovery: ``DB.crash()`` discards
  everything volatile and ``DB.reopen()`` rebuilds from durable state with
  WAL replay.  The crash itself is orchestrated by the open-loop runner
  (``run_open_loop(faults=...)``), which must also account for the ops it
  kills; the injector only arms the window faults.

All times are in virtual seconds relative to ``FaultInjector.arm()``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

SSD, HDD, BOTH = "ssd", "hdd", "both"


@dataclass(frozen=True)
class StallWindow:
    """Device freeze: I/O submitted in [at, at + duration) waits it out.

    ``shard`` targets one shard store of a ``repro_torch.cluster.ShardedDB``
    (None = every store; ignored on a bare ``DB``)."""

    at: float
    duration: float
    device: str = SSD            # "ssd" | "hdd" | "both"
    shard: Optional[int] = None


@dataclass(frozen=True)
class SlowWindow:
    """Bandwidth degradation: service times x ``factor`` during the window."""

    at: float
    duration: float
    factor: float = 4.0
    device: str = HDD
    shard: Optional[int] = None


@dataclass(frozen=True)
class ZoneReset:
    """Spontaneous zone reset at ``at``; ``zid=None`` picks the first zone
    currently owned by an SST (deterministic, so runs are reproducible)."""

    at: float
    device: str = SSD
    zid: Optional[int] = None
    shard: Optional[int] = None


@dataclass(frozen=True)
class FaultSpec:
    """Declarative fault schedule for one run (times relative to run start).

    ``recovery_slo_s`` is a recovery-time SLO budget for the crash point:
    runs report ``recovery_slo_s``/``recovery_slo_met`` columns comparing
    the measured downtime (crash → serving again, WAL replay included)
    against it.
    """

    name: str = "faults"
    crash_at: Optional[float] = None
    # crash only this shard of a ShardedDB at crash_at (None = whole
    # store); the other shards keep serving while it replays its WAL
    crash_shard: Optional[int] = None
    stalls: Tuple[StallWindow, ...] = ()
    slows: Tuple[SlowWindow, ...] = ()
    zone_resets: Tuple[ZoneReset, ...] = ()
    recovery_slo_s: Optional[float] = None

    @property
    def label(self) -> str:
        """Human-readable schedule, used in result rows and reports."""
        parts = []
        if self.crash_at is not None:
            who = (f"(s{self.crash_shard})"
                   if self.crash_shard is not None else "")
            parts.append(f"crash{who}@{self.crash_at:g}")
        for s in self.stalls:
            parts.append(f"stall[{_dev_label(s)}]@{s.at:g}+{s.duration:g}")
        for s in self.slows:
            parts.append(f"slow[{_dev_label(s)}]x{s.factor:g}"
                         f"@{s.at:g}+{s.duration:g}")
        for z in self.zone_resets:
            parts.append(f"zreset[{_dev_label(z)}]@{z.at:g}")
        return ",".join(parts) if parts else "none"


def _dev_label(w) -> str:
    if w.shard is None:
        return w.device
    return f"s{w.shard}.{w.device}"


class FaultInjector:
    """Arms a ``FaultSpec``'s stall/slow/zone-reset events on a ``DB``.

    Each fault is a daemon process on the DB's simulator: it does not keep
    the run alive, and a fault scheduled past the end of the run simply
    never fires.  ``crash_at`` is deliberately NOT armed here — the runner
    owns the crash because it must coordinate in-flight op accounting
    around ``DB.crash()``/``DB.reopen()``.
    """

    def __init__(self, db, spec: FaultSpec):
        self.db = db
        self.spec = spec
        self.t0 = 0.0
        self.fired = {"stalls": 0, "slows": 0, "zone_resets": 0}

    # ------------------------------------------------------------------
    def arm(self, t0: Optional[float] = None,
            after: float = float("-inf")) -> None:
        """Spawn the fault processes.  ``t0`` anchors the schedule (default:
        now); ``after`` skips windows at or before that relative time —
        used to re-arm the not-yet-fired remainder after a crash killed
        the injector's processes along with everything else."""
        sim = self.db.sim
        self.t0 = sim.now if t0 is None else t0
        for w in self.spec.stalls:
            if w.at > after:
                sim.process(self._stall(w))
        for w in self.spec.slows:
            if w.at > after:
                sim.process(self._slow(w))
        for w in self.spec.zone_resets:
            if w.at > after:
                sim.process(self._zone_reset(w))

    def _dbs(self, shard: Optional[int]):
        """Target stores of a window: the shard stores of a ShardedDB
        (one of them when ``shard`` is set) or the bare DB itself."""
        subs = getattr(self.db, "shards", None)
        if subs is None or isinstance(subs, int):
            return [self.db]
        if shard is None:
            return list(subs)
        return [subs[shard]]

    def _devices(self, which: str, shard: Optional[int] = None):
        devs = []
        for db in self._dbs(shard):
            if which == BOTH:
                devs.extend([db.ssd, db.hdd])
            else:
                devs.append(db.backend.device_of(which))
        return devs

    def _wait(self, at: float):
        delay = self.t0 + at - self.db.sim.now
        if delay > 0:
            yield self.db.sim.timeout(delay, daemon=True)

    # ------------------------------------------------------------------
    def _stall(self, w: StallWindow):
        yield from self._wait(w.at)
        for dev in self._devices(w.device, w.shard):
            dev.stall(w.duration)
        self.fired["stalls"] += 1

    def _slow(self, w: SlowWindow):
        yield from self._wait(w.at)
        for dev in self._devices(w.device, w.shard):
            dev.degrade(w.duration, w.factor)
        self.fired["slows"] += 1

    def _zone_reset(self, w: ZoneReset):
        yield from self._wait(w.at)
        for db in self._dbs(w.shard):
            dev = db.backend.device_of(w.device)
            zone = self._pick(dev, w.zid)
            if zone is not None:
                db.backend.on_zone_fault(w.device, zone)
                self.fired["zone_resets"] += 1

    @staticmethod
    def _pick(dev, zid: Optional[int]):
        if zid is not None:
            return dev.zones[zid]
        for z in dev.zones:   # deterministic victim: first SST-owned zone
            if z.owner is not None and z.owner.startswith("sst:"):
                return z
        return None
