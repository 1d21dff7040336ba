"""Hint types passed from the LSM-tree KV store to the HHZS middleware (§3.1).

Each hint is tens of bytes in the real system; here they are small dataclasses
flowing synchronously alongside the corresponding operation.  The same hint
vocabulary is reused by the KV-cache tier manager of the serving layer
(``serving/tiering.py``): prefill ≙ flush, sequence growth across length
buckets ≙ compaction, HBM block-pool eviction ≙ cache eviction.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple


@dataclass(frozen=True)
class FlushHint:
    """Identifies an SST about to be written at L0 by a flush operation."""
    sst_id: int


@dataclass(frozen=True)
class CompactionTriggerHint:
    """Phase (i): compaction triggered; identifies selected SSTs + target level."""
    cid: int
    selected_sst_ids: Tuple[int, ...]
    target_level: int


@dataclass(frozen=True)
class CompactionOutputHint:
    """Phase (ii): compaction generates one output SST at ``level``."""
    cid: int
    sst_id: int
    level: int


@dataclass(frozen=True)
class CompactionDoneHint:
    """Phase (iii): compaction complete; generated SSTs identified."""
    cid: int
    target_level: int
    num_selected: int
    num_generated: int
    input_sst_ids: Tuple[int, ...] = ()
    output_sst_ids: Tuple[int, ...] = ()


@dataclass(frozen=True)
class CacheHint:
    """In-memory block cache evicted a data block (SST id + offset)."""
    sst_id: int
    block_idx: int
