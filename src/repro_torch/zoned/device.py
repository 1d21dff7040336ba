"""Zoned storage devices with the paper's timing model (Table 1).

A ``ZonedDevice`` exposes the zoned interface of §2.1: fixed-capacity
append-only zones with a write pointer, explicit reset, sequential writes
only.  Service times come from a calibrated model:

  sequential I/O : per-request submission overhead + bytes / bandwidth
  random read    : 1/IOPS for the first 4 KiB (seek + transfer, calibrated
                   against the measured fio IOPS) + remaining bytes / bandwidth

Devices are FIFO resources: an I/O submitted while the device is busy queues
behind earlier I/O — this is what creates the foreground/background
interference the paper measures in Exp#6.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .sim import Sim

MiB = float(1 << 20)
KiB = float(1 << 10)


@dataclass(frozen=True)
class DeviceTiming:
    """Calibrated against Table 1 of the paper."""

    seq_read_bw: float    # bytes/s
    seq_write_bw: float   # bytes/s
    rand_read_iops: float  # 4 KiB random read IOPS
    seq_overhead: float   # per-request submission overhead, seconds

    @property
    def rand_read_base(self) -> float:
        """Service time of a 4 KiB random read."""
        return 1.0 / self.rand_read_iops


# Table 1: WD Ultrastar DC ZN540 (ZNS SSD), Seagate ST14000NM0007 (HM-SMR HDD)
ZN540_SSD = DeviceTiming(
    seq_read_bw=1039.6 * MiB,
    seq_write_bw=1002.8 * MiB,
    rand_read_iops=16928.3,
    seq_overhead=10e-6,
)
ST14000_HDD = DeviceTiming(
    seq_read_bw=210.0 * MiB,
    seq_write_bw=210.0 * MiB,
    rand_read_iops=115.0,
    seq_overhead=100e-6,
)


class ZoneState(enum.Enum):
    EMPTY = "empty"
    OPEN = "open"
    FULL = "full"


@dataclass
class Zone:
    zid: int
    capacity: int                  # writable zone capacity, bytes
    write_ptr: int = 0
    state: ZoneState = ZoneState.EMPTY
    owner: Optional[str] = None    # free-form tag: "wal", "cache", "sst:<id>"

    @property
    def remaining(self) -> int:
        return self.capacity - self.write_ptr


@dataclass
class TrafficCounters:
    read_bytes: float = 0.0
    write_bytes: float = 0.0
    read_ops: int = 0
    write_ops: int = 0
    busy_time: float = 0.0
    by_tag_write: Dict[str, float] = field(default_factory=dict)
    by_tag_read: Dict[str, float] = field(default_factory=dict)


class ZonedDevice:
    """Append-only zoned device + FIFO service queue in virtual time."""

    def __init__(self, sim: Sim, name: str, timing: DeviceTiming,
                 num_zones: int, zone_capacity: int, batched: bool = True):
        self.sim = sim
        self.name = name
        self.timing = timing
        self.zone_capacity = zone_capacity
        self.zones: List[Zone] = [Zone(zid=i, capacity=zone_capacity)
                                  for i in range(num_zones)]
        self._busy_until = 0.0
        self._bg_busy_until = 0.0
        # batched completion path: each FIFO track completes I/O in
        # nondecreasing time, so completions ride a per-track
        # MonotoneQueue (O(1) schedule, one heap entry per track) instead
        # of one heap timeout per request.  ``batched=False`` keeps the
        # per-request heap path — bit-identical virtual times, used by the
        # differential test in tests/test_zoned.py.
        self._fg_q = sim.monotone_queue() if batched else None
        self._bg_q = sim.monotone_queue() if batched else None
        # fault-injection hooks (repro_torch.zoned.faults): while sim.now is
        # before _slow_until, service times are scaled by _slow_factor
        self._slow_until = 0.0
        self._slow_factor = 1.0
        self.counters = TrafficCounters()
        self.resets = 0

    # ------------------------------------------------------------------
    # zone management (the zoned interface)
    # ------------------------------------------------------------------
    def empty_zones(self) -> List[Zone]:
        return [z for z in self.zones if z.state == ZoneState.EMPTY]

    def num_empty(self) -> int:
        return sum(1 for z in self.zones if z.state == ZoneState.EMPTY)

    def alloc_zone(self, owner: str) -> Zone:
        for z in self.zones:
            if z.state == ZoneState.EMPTY:
                z.state = ZoneState.OPEN
                z.owner = owner
                return z
        raise RuntimeError(f"{self.name}: no empty zone for {owner!r}")

    def reset_zone(self, zone: Zone) -> None:
        """Reset: write pointer back to start; all data in the zone is gone."""
        zone.write_ptr = 0
        zone.state = ZoneState.EMPTY
        zone.owner = None
        self.resets += 1

    def finish_zone(self, zone: Zone) -> None:
        zone.state = ZoneState.FULL

    # ------------------------------------------------------------------
    # timed I/O
    # ------------------------------------------------------------------
    def _service_time(self, nbytes: float, kind: str) -> float:
        t = self.timing
        if kind == "seq_read":
            return t.seq_overhead + nbytes / t.seq_read_bw
        if kind == "seq_write":
            return t.seq_overhead + nbytes / t.seq_write_bw
        if kind == "rand_read":
            extra = max(0.0, nbytes - 4 * KiB)
            return t.rand_read_base + extra / t.seq_read_bw
        raise ValueError(kind)

    def io(self, nbytes: float, kind: str, tag: str = "",
           background: bool = False):
        """Submit an I/O; returns a completion the caller ``yield``-s.

        On the batched path this is a :class:`~repro_torch.zoned.sim.MonotoneQueue`
        completion ticket (no Event allocated); with ``batched=False`` (or
        after a mid-crash ``restart()`` broke the track's monotonicity) it
        is a real Event scheduled at the same absolute completion time.
        Either way a process just ``yield``-s it.

        Foreground I/O queues FIFO.  Background I/O (rate-limited migration,
        cache-zone fills) models the drive's internal scheduler merging it
        into the stream: it completes on its own background track but still
        consumes device capacity — foreground feels it as added busy time.
        """
        service = self._service_time(nbytes, kind)
        if self.sim.now < self._slow_until:
            service *= self._slow_factor
        if background:
            start = max(self.sim.now, self._bg_busy_until)
            end = start + service
            self._bg_busy_until = end
            # capacity interference: foreground queue grows by the same work
            self._busy_until = max(self._busy_until, self.sim.now) + service
            q = self._bg_q
        else:
            start = max(self.sim.now, self._busy_until)
            end = start + service
            self._busy_until = end
            q = self._fg_q
        c = self.counters
        c.busy_time += service
        if kind.endswith("read"):
            c.read_bytes += nbytes
            c.read_ops += 1
            if tag:
                c.by_tag_read[tag] = c.by_tag_read.get(tag, 0.0) + nbytes
        else:
            c.write_bytes += nbytes
            c.write_ops += 1
            if tag:
                c.by_tag_write[tag] = c.by_tag_write.get(tag, 0.0) + nbytes
        if q is not None:
            return q.complete_at(end)
        return self.sim.schedule_at(end)

    def append(self, zone: Zone, nbytes: int, tag: str = "",
               background: bool = False):
        """Sequential append at the zone's write pointer (§2.1)."""
        if zone.state == ZoneState.FULL:
            raise RuntimeError(f"{self.name}: append to FULL zone {zone.zid}")
        if zone.state == ZoneState.EMPTY:
            zone.state = ZoneState.OPEN
        if nbytes > zone.remaining:
            raise RuntimeError(
                f"{self.name}: append {nbytes}B > remaining {zone.remaining}B "
                f"in zone {zone.zid}")
        zone.write_ptr += nbytes
        if zone.remaining == 0:
            zone.state = ZoneState.FULL
        return self.io(nbytes, "seq_write", tag=tag, background=background)

    def read(self, nbytes: float, random: bool, tag: str = "",
             background: bool = False):
        return self.io(nbytes, "rand_read" if random else "seq_read",
                       tag=tag, background=background)

    # ------------------------------------------------------------------
    # fault hooks (repro_torch.zoned.faults)
    # ------------------------------------------------------------------
    def stall(self, duration: float) -> None:
        """Freeze the device for new work: every I/O *submitted* from now
        until the window ends queues behind it (models internal GC /
        firmware hiccups).  I/O already submitted keeps its precomputed
        completion time — the FIFO model schedules completions at submit,
        so an in-flight request is treated as already past the point the
        stall can affect."""
        end = self.sim.now + duration
        self._busy_until = max(self._busy_until, end)
        self._bg_busy_until = max(self._bg_busy_until, end)

    def degrade(self, duration: float, factor: float) -> None:
        """Transient bandwidth degradation: service times are multiplied by
        ``factor`` for I/O submitted in the next ``duration`` seconds."""
        self._slow_until = max(self._slow_until, self.sim.now + duration)
        self._slow_factor = factor

    def restart(self) -> None:
        """Crash/power-cycle hook: the in-device queue drains with the power
        (queued service obligations are gone; zones keep their pointers)."""
        self._busy_until = self._bg_busy_until = self.sim.now
        self._slow_until = 0.0
        self._slow_factor = 1.0

    # ------------------------------------------------------------------
    def utilization(self) -> float:
        if self.sim.now <= 0:
            return 0.0
        return self.counters.busy_time / self.sim.now

    def queue_depth_s(self, background: bool = False) -> float:
        """Seconds of service backlog on the (fore/back)ground track: how
        long an I/O submitted now would wait before starting."""
        until = self._bg_busy_until if background else self._busy_until
        return max(0.0, until - self.sim.now)

    def zone_occupancy(self) -> Dict[str, int]:
        """Zone counts by state (single pass; EMPTY/OPEN/FULL)."""
        empty = opened = full = 0
        for z in self.zones:
            s = z.state
            if s is ZoneState.EMPTY:
                empty += 1
            elif s is ZoneState.OPEN:
                opened += 1
            else:
                full += 1
        return {"empty": empty, "open": opened, "full": full}

    # ------------------------------------------------------------------
    # telemetry (repro_torch.obs) — pull gauges only: io() is untouched
    # ------------------------------------------------------------------
    def install_metrics(self, reg, prefix: Optional[str] = None) -> None:
        """Register this device's per-tier signals on a ``MetricsRegistry``:
        queue depth (fg/bg backlog seconds), utilization, zone occupancy by
        state, and windowed read/write byte rates."""
        p = prefix or self.name
        reg.gauge(f"{p}.qdepth_s", self.queue_depth_s)
        reg.gauge(f"{p}.bg_qdepth_s",
                  lambda: self.queue_depth_s(background=True))
        reg.gauge(f"{p}.util", self.utilization)
        reg.collector(lambda: {
            f"{p}.zones.{k}": float(v)
            for k, v in self.zone_occupancy().items()})
        reg.collector(lambda: {
            f"{p}.read_rate": self.counters.read_bytes,
            f"{p}.write_rate": self.counters.write_bytes,
        }, rate=True)
