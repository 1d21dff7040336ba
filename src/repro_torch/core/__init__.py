"""The paper's contribution: hinted data management for hybrid zoned storage.

- ``hints``         hint vocabulary (§3.1)
- ``placement``     write-guided data placement + baselines (§3.3, §2.3, §4.1)
- ``migration``     workload-aware migration (§3.4)
- ``hinted_cache``  application-hinted caching (§3.5)
- ``middleware``    the HHZS middleware gluing the above onto zoned devices,
                    plus the multi-tenant admission-control layer
                    (``AdmissionController``: none / reject-at-pressure /
                    delay-at-pressure / per-tenant token bucket)

The reference package reuses the same placement/migration/caching
machinery to tier paged KV-cache blocks across accelerator and host memory
(``serving/tiering.py``); that serving layer is not ported yet.
"""
from .hints import (FlushHint, CompactionTriggerHint, CompactionOutputHint,
                    CompactionDoneHint, CacheHint)
from .placement import (PlacementPolicy, BasicScheme, AutoPlacement,
                        HHZSPlacement)
from .migration import Migrator, priority_key
from .hinted_cache import HintedCache
from .middleware import (ADMISSION_POLICIES, AdmissionConfig,
                         AdmissionController, HybridZonedBackend)

__all__ = [
    "FlushHint", "CompactionTriggerHint", "CompactionOutputHint",
    "CompactionDoneHint", "CacheHint",
    "PlacementPolicy", "BasicScheme", "AutoPlacement", "HHZSPlacement",
    "Migrator", "priority_key", "HintedCache", "HybridZonedBackend",
    "ADMISSION_POLICIES", "AdmissionConfig", "AdmissionController",
]
