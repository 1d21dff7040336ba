from .sim import Sim, Event, MonotoneQueue, Process, Semaphore
from .device import (
    DeviceTiming, Zone, ZoneState, ZonedDevice, ZN540_SSD, ST14000_HDD,
    MiB, KiB,
)
from .faults import (FaultInjector, FaultSpec, SlowWindow, StallWindow,
                     ZoneReset)

__all__ = [
    "Sim", "Event", "MonotoneQueue", "Process", "Semaphore",
    "DeviceTiming", "Zone", "ZoneState", "ZonedDevice",
    "ZN540_SSD", "ST14000_HDD", "MiB", "KiB",
    "FaultInjector", "FaultSpec", "StallWindow", "SlowWindow", "ZoneReset",
]
