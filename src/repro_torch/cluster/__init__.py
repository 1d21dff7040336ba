"""Sharded multi-DB store: routing, per-shard faults, online splitting.

The paper's hint-driven placement/migration/caching (§3.3-3.5) is a
per-store design; this package scales it horizontally the way production
KV services do — N independent shard stores (each a full
``repro_torch.lsm.DB`` with its own devices, WAL, hint pipeline and, on
``torch_device``, Bloom filter image) on ONE shared DES clock,
fronted by a routing layer that keeps the single-store facade
(``submit/get/get_batch/run_for``) intact.  See
``docs/ARCHITECTURE.md`` ("Sharded cluster layer") for the design.
"""
from .router import HashRouter, RangeRouter
from .sharded import INF, RouterKV, ShardedDB, live_keys_in_range

__all__ = ["ShardedDB", "RouterKV", "HashRouter", "RangeRouter",
           "live_keys_in_range", "INF"]
