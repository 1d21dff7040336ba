"""Tier-placement policy baselines for the serving scenario family.

Three policies, selectable in the scenario grid the way storage schemes
are (``--policies static,lru,hhzs``):

``static``
    HBM-only with rejection: a sequence is admitted iff its *whole*
    budgeted footprint (prompt + max output tokens) fits in free HBM
    zones, accounting for the unfilled growth of already-admitted
    sequences.  Never demotes, never migrates — the "provision for peak
    or shed" strawman a tiered design is measured against.

``lru``
    Two-tier with plain LRU demotion and no hints: every prefill lands in
    HBM regardless of demand, the demotion victim is chosen purely by
    recency, and there is no prefix cache.  This is the classic
    hint-blind paging baseline (≙ the conventional-zoned-storage baseline
    of the paper's evaluation).

``hhzs``
    The full hint-driven manager (`HHZSKVManager`): §3.3 write-guided
    placement, §3.4 capacity/popularity migration with level-aware victim
    choice, §3.5 eviction-driven prefix caching.
"""
from __future__ import annotations

from typing import Dict

from .paged_kv import PagedPool
from .tiering import HHZSKVManager, SeqKV

POLICIES = ("static", "lru", "hhzs")


class LRUKVManager(HHZSKVManager):
    """Hint-blind baseline: HBM-first placement, recency-only eviction,
    no prefix cache."""

    def __init__(self, hbm: PagedPool, host: PagedPool,
                 migration_zone_budget_per_step: int = 1):
        super().__init__(
            hbm, host, cache_zones=0,
            migration_zone_budget_per_step=migration_zone_budget_per_step)

    def on_prefill(self, sid: int, tokens: int) -> SeqKV:
        # no write-guided placement: always start in HBM and let demand
        # pressure evict whoever is least recently used
        seq = SeqKV(sid=sid, last_active_step=self.step, tier="hbm")
        self.seqs[sid] = seq
        self.stats["hbm_placements"] += 1
        return seq

    def _victim_key(self, s: SeqKV):
        return (self.step - s.last_active_step, s.sid)

    def tick(self, active_sids) -> None:
        # hint-blind paging: an active host-resident sequence is promoted
        # by evicting whoever is least recently used — even another
        # sequence of the current batch (the promote/demote ping-pong the
        # hinted manager's cold-only rule avoids)
        self.step += 1
        for sid in active_sids:
            if sid in self.seqs:
                self.seqs[sid].last_active_step = self.step
        budget = self.migration_budget
        for sid in active_sids:
            seq = self.seqs.get(sid)
            if seq is None or seq.tier != "host" or budget <= 0:
                continue
            if self.hbm.num_free() >= len(seq.zones):
                budget -= self._promote(seq)
            elif self._demote_one(exclude=sid):
                budget -= self._promote(seq)


class StaticHBMManager(HHZSKVManager):
    """HBM-only with admission rejection; no host tier, no migration."""

    def __init__(self, hbm: PagedPool, host: PagedPool):
        super().__init__(hbm, host, cache_zones=0,
                         migration_zone_budget_per_step=0)
        self._commit: Dict[int, int] = {}   # sid -> budgeted total tokens

    def _outstanding(self) -> int:
        """HBM zones already promised to admitted sequences but not yet
        allocated (their future decode growth)."""
        out = 0
        for sid, total in self._commit.items():
            seq = self.seqs.get(sid)
            held = len(seq.zones) if seq is not None else 0
            out += max(0, self._zones_for(total) - held)
        return out

    def admit(self, sid: int, total_tokens: int) -> bool:
        if self._zones_for(total_tokens) > \
                self.hbm.num_free() - self._outstanding():
            return False
        self._commit[sid] = total_tokens
        return True

    def on_prefill(self, sid: int, tokens: int) -> SeqKV:
        seq = SeqKV(sid=sid, last_active_step=self.step, tier="hbm")
        self.seqs[sid] = seq
        self.stats["hbm_placements"] += 1
        return seq

    def writable_zone(self, seq: SeqKV):
        if seq.zones and seq.zones[-1].remaining(self.hbm.page_size) > 0:
            return seq.zones[-1]
        z = self.hbm.alloc_zone(seq.sid)
        if z is None:
            raise RuntimeError(
                "static policy: HBM pool exhausted — admission reservation "
                "accounting is broken")
        seq.zones.append(z)
        return z

    def tick(self, active_sids) -> None:
        self.step += 1
        for sid in active_sids:
            if sid in self.seqs:
                self.seqs[sid].last_active_step = self.step

    def release(self, sid: int) -> None:
        super().release(sid)
        self._commit.pop(sid, None)


def make_manager(policy: str, hbm: PagedPool, host: PagedPool, *,
                 cache_zones: int = 2,
                 migration_zone_budget_per_step: int = 1) -> HHZSKVManager:
    if policy == "static":
        return StaticHBMManager(hbm, host)
    if policy == "lru":
        return LRUKVManager(
            hbm, host,
            migration_zone_budget_per_step=migration_zone_budget_per_step)
    if policy == "hhzs":
        return HHZSKVManager(
            hbm, host, cache_zones=cache_zones,
            migration_zone_budget_per_step=migration_zone_budget_per_step)
    raise ValueError(f"unknown serving policy {policy!r} "
                     f"(known: {', '.join(POLICIES)})")
