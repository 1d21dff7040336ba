"""Data placement policies for hybrid zoned storage.

Implements the paper's §2.3 basic schemes (Bh), the SpanDB automated
placement (AUTO, §4.1), and HHZS write-guided data placement (§3.3):

  Step 1  storage demands per level from flushing/compaction hints
  Step 2  tiering level  t = argmin_t Σ_{j<=t} (A_j + D_j) >= C_ssd
  Step 3  SSD zones reserved for L_t = C_ssd - Σ_{j<t} (A_j + D_j)
  Step 4  zone selection for each written SST
"""
from __future__ import annotations

from collections import defaultdict
from typing import Optional, TYPE_CHECKING

from .hints import (CacheHint, CompactionDoneHint, CompactionOutputHint,
                    CompactionTriggerHint, FlushHint)

if TYPE_CHECKING:
    from .middleware import HybridZonedBackend

SSD, HDD = "ssd", "hdd"


class PlacementPolicy:
    """Decides the tier for each written SST; consumes LSM hints."""

    name = "base"
    reserves_wal = False    # carve WAL(+cache) zones out of the SSD pool?

    def __init__(self) -> None:
        self.backend: Optional["HybridZonedBackend"] = None

    def attach(self, backend: "HybridZonedBackend") -> None:
        self.backend = backend

    def on_hint(self, hint) -> None:  # pragma: no cover - default no-op
        pass

    def start(self) -> None:
        """Spawn any background processes (AUTO's throughput monitor)."""

    def on_reopen(self) -> None:
        """Crash recovery: drop volatile state (hint-derived demand from
        compactions that died with the crash, stale monitor samples)."""

    def choose_tier(self, level: int, source: str) -> str:
        raise NotImplementedError

    # HHZS exposes its tiering level to the migrator; others don't tier.
    def tiering_level(self) -> int:
        return 10**9


class BasicScheme(PlacementPolicy):
    """Bh (§2.3): WAL + SSTs at levels < h go to the SSD when space allows."""

    reserves_wal = False

    def __init__(self, h: int):
        super().__init__()
        self.h = h
        self.name = f"B{h}"

    def choose_tier(self, level: int, source: str) -> str:
        if level < self.h and self.backend.ssd_has_empty_sst_zone():
            return SSD
        return HDD

    def tiering_level(self) -> int:
        return self.h


class AutoPlacement(PlacementPolicy):
    """SpanDB's automated placement (re-implemented per §4.1).

    A monitor samples SSD write throughput once per second: below 40% of
    the device's sequential-write bandwidth the max level is raised, above
    65% it is lowered.  Remaining-space guards: < 13.3% -> max level pinned
    to 1; < 8% -> no SST writes to the SSD at all.  WAL zones are reserved,
    as in HHZS.
    """

    name = "AUTO"
    reserves_wal = True

    def __init__(self, lo_frac: float = 0.40, hi_frac: float = 0.65,
                 space_pin_frac: float = 0.133, space_stop_frac: float = 0.08,
                 period: float = 1.0, max_level_cap: int = 6):
        super().__init__()
        self.lo_frac = lo_frac
        self.hi_frac = hi_frac
        self.space_pin_frac = space_pin_frac
        self.space_stop_frac = space_stop_frac
        self.period = period
        self.max_level = 1
        self.max_level_cap = max_level_cap
        self._last_write_bytes = 0.0

    def start(self) -> None:
        self.backend.sim.process(self._monitor())

    def on_reopen(self) -> None:
        # device counters survive a crash but the monitor didn't sample
        # during the outage: resync so the first delta isn't inflated
        self._last_write_bytes = self.backend.ssd.counters.write_bytes

    def _monitor(self):
        be = self.backend
        while True:
            yield be.sim.timeout(self.period, daemon=True)
            wb = be.ssd.counters.write_bytes
            thpt = (wb - self._last_write_bytes) / self.period
            self._last_write_bytes = wb
            peak = be.ssd.timing.seq_write_bw
            if thpt < self.lo_frac * peak:
                self.max_level = min(self.max_level + 1, self.max_level_cap)
            elif thpt > self.hi_frac * peak:
                self.max_level = max(self.max_level - 1, 0)

    def _remaining_frac(self) -> float:
        be = self.backend
        total = len(be.ssd.zones)
        return be.ssd.num_empty() / max(total, 1)

    def choose_tier(self, level: int, source: str) -> str:
        rem = self._remaining_frac()
        if rem < self.space_stop_frac:
            return HDD
        max_level = 1 if rem < self.space_pin_frac else self.max_level
        if level <= max_level and self.backend.ssd_has_empty_sst_zone():
            return SSD
        return HDD

    def tiering_level(self) -> int:
        return self.max_level + 1


class HHZSPlacement(PlacementPolicy):
    """Write-guided data placement (§3.3)."""

    name = "HHZS-P"
    reserves_wal = True

    def __init__(self, num_levels: int = 7):
        super().__init__()
        self.num_levels = num_levels
        self.demand = defaultdict(float)   # D_i, i >= 1, from compaction hints
        self._live_compactions = {}        # cid -> target level (sanity)

    # -- Step 1: storage demands from hints ---------------------------------
    def on_hint(self, hint) -> None:
        # demand is tracked per live compaction so that a compaction which
        # generates *more* SSTs than it selected (possible when many small
        # L0 files merge) cannot leave phantom demand behind: each cid's
        # remaining demand is clamped >= 0 and zeroed at completion.
        if isinstance(hint, CompactionTriggerHint):
            self._live_compactions[hint.cid] = (
                hint.target_level, float(len(hint.selected_sst_ids)))
        elif isinstance(hint, CompactionOutputHint):
            if hint.cid in self._live_compactions:
                lvl, rem = self._live_compactions[hint.cid]
                self._live_compactions[hint.cid] = (lvl, max(0.0, rem - 1.0))
        elif isinstance(hint, CompactionDoneHint):
            self._live_compactions.pop(hint.cid, None)

    def on_reopen(self) -> None:
        # the compactions behind these demands died with the crash; their
        # cids will never emit a Done hint, so the demand must be dropped
        # here or it pins the tiering level forever
        self._live_compactions.clear()

    def demand_of(self, level: int) -> float:
        if level == 0:
            # D_0 = number of WAL zones currently in use (§3.3 Step 1): every
            # MemTable KV object has a WAL copy, so live WAL zones are a proxy
            # for the flush backlog HHZS cannot observe directly.
            return float(self.backend.wal_zones_in_use())
        return sum(rem for lvl, rem in self._live_compactions.values()
                   if lvl == level)

    def allocated_of(self, level: int) -> int:
        """A_i: SSD zones currently allocated to SSTs at level i."""
        return self.backend.ssd_sst_count_at_level(level)

    # -- Step 2: tiering level ----------------------------------------------
    def tiering_level(self) -> int:
        c_ssd = self.backend.c_ssd()
        cum = 0.0
        for lvl in range(self.num_levels):
            cum += self.allocated_of(lvl) + self.demand_of(lvl)
            if cum >= c_ssd:
                return lvl
        return self.num_levels

    # -- Step 3: reservation for L_t ----------------------------------------
    def reserved_for_tiering(self, t: int) -> float:
        c_ssd = self.backend.c_ssd()
        below = sum(self.allocated_of(j) + self.demand_of(j) for j in range(t))
        return c_ssd - below

    # -- Step 4: zone selection ---------------------------------------------
    def choose_tier(self, level: int, source: str) -> str:
        be = self.backend
        if not be.ssd_has_empty_sst_zone():
            return HDD
        if source == "flush":
            return SSD
        t = self.tiering_level()
        if level < t:
            return SSD
        if level == t and self.allocated_of(t) < self.reserved_for_tiering(t):
            return SSD
        return HDD
