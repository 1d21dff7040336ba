"""LLM KV-cache serving over HHZS-tiered paged KV: the paged pools, the
tier managers and policies, and the engine that runs the model with the
port's attention kernels."""
from .paged_kv import PagedPool, KVZone
from .tiering import HHZSKVManager, SeqKV
from .policies import (POLICIES, LRUKVManager, StaticHBMManager,
                       make_manager)
from .engine import ServingEngine, Request

__all__ = ["PagedPool", "KVZone", "HHZSKVManager", "SeqKV",
           "POLICIES", "LRUKVManager", "StaticHBMManager", "make_manager",
           "ServingEngine", "Request"]
