"""Paged KV storage with zone semantics, two-tier (HBM / host).

The HHZS mapping onto the card:

  ZNS SSD            -> device page pool (fast, scarce): a CUDA tensor
  HM-SMR HDD         -> host-memory page pool (slow, plentiful): numpy
  zone               -> fixed group of KV pages, allocated append-only via
                        a write pointer and reset *as a unit* when the
                        owning sequence retires (no per-page GC — the same
                        no-translation-layer property zoned storage gives)
  SST                -> one sequence's KV segment (a list of zones)
  LSM level          -> sequence length bucket (exponentially growing)

Pools hold stacked per-layer pages [L, P, page_size, KV, D] float32.  The
device tier lives on ``torch_device`` and is written in place; the host
tier is numpy (pageable host RAM).  Promotion and demotion copy zones
between tiers: the host-to-device and device-to-host copies of a real
serving stack.

``materialize=False`` builds an accounting-only pool: zones, write
pointers, byte counters and conservation invariants all behave exactly as
with real arrays, but no tensor data is stored or copied.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch


@dataclass
class KVZone:
    zid: int
    pages: List[int]               # page indices inside the pool
    write_ptr: int = 0             # tokens written into this zone
    owner: Optional[int] = None    # sequence id

    def remaining(self, page_size: int) -> int:
        return len(self.pages) * page_size - self.write_ptr


def _host(x) -> np.ndarray:
    """K/V data as float32 numpy (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


class PagedPool:
    """One tier's KV pages grouped into zones."""

    def __init__(self, name: str, num_layers: int, num_zones: int,
                 pages_per_zone: int, page_size: int, kv_heads: int,
                 head_dim: int, host: bool, materialize: bool = True,
                 torch_device="cuda"):
        self.name = name
        self.page_size = page_size
        self.pages_per_zone = pages_per_zone
        self.num_pages = num_zones * pages_per_zone
        # bytes of one token's K+V across all layers (float32 K and V)
        self.token_bytes = num_layers * kv_heads * head_dim * 4 * 2
        self.materialize = materialize
        shape = (num_layers, self.num_pages, page_size, kv_heads, head_dim)
        if not materialize:
            self.k = self.v = None
        elif host:
            self.k = np.zeros(shape, np.float32)
            self.v = np.zeros(shape, np.float32)
        else:
            dev = torch.device(torch_device)
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"{name}: no CUDA card visible for the "
                                   "device tier; pass torch_device='cpu' to "
                                   "keep it on the CPU")
            self.k = torch.zeros(shape, dtype=torch.float32, device=dev)
            self.v = torch.zeros(shape, dtype=torch.float32, device=dev)
        self.host = host
        self.zones = [
            KVZone(zid=i, pages=list(range(i * pages_per_zone,
                                           (i + 1) * pages_per_zone)))
            for i in range(num_zones)]
        self._free = list(range(num_zones))
        # traffic accounting (bytes) for the serving report
        self.bytes_written = 0
        self.bytes_read = 0

    def num_free(self) -> int:
        return len(self._free)

    def alloc_zone(self, owner: int) -> Optional[KVZone]:
        if not self._free:
            return None
        z = self.zones[self._free.pop(0)]
        if z.owner is not None:
            raise RuntimeError(
                f"{self.name}: free-list zone {z.zid} still owned by "
                f"{z.owner} — zone accounting corrupted")
        z.owner = owner
        z.write_ptr = 0
        return z

    def reset_zone(self, zone: KVZone) -> None:
        """Zone reset: write pointer to start, space reclaimed at once.

        Double-resetting a zone would put it on the free list twice and
        hand it to two owners later — raise instead (the symptom of a
        tier-manager bookkeeping bug, not a recoverable condition).
        """
        if zone.owner is None:
            raise RuntimeError(
                f"{self.name}: zone {zone.zid} reset twice (already free)")
        zone.owner = None
        zone.write_ptr = 0
        self._free.append(zone.zid)

    # ------------------------------------------------------------------
    def next_slot(self, zone: KVZone):
        """(page, slot) the zone's next token goes to."""
        assert zone.remaining(self.page_size) > 0
        idx = zone.write_ptr
        return zone.pages[idx // self.page_size], idx % self.page_size

    def put(self, layers, page: int, slot: int, k, v) -> None:
        """Store K/V at (page, slot) for ``layers`` (an index or a slice
        of the layer axis) in place, without moving the write pointer."""
        if isinstance(self.k, np.ndarray):
            self.k[layers, page, slot] = _host(k)
            self.v[layers, page, slot] = _host(v)
        else:
            self.k[layers, page, slot] = torch.as_tensor(k).to(self.k.device)
            self.v[layers, page, slot] = torch.as_tensor(v).to(self.v.device)

    def advance(self, zone: KVZone) -> int:
        """Count one written token: move the write pointer and the byte
        counter.  Returns the token's encoded (page, slot) position."""
        page, slot = self.next_slot(zone)
        zone.write_ptr += 1
        self.bytes_written += self.token_bytes
        return page * self.page_size + slot

    def write_token(self, zone: KVZone, layer_k=None, layer_v=None) -> int:
        """Append one token's [L, KV, D] K/V at the zone write pointer.
        Returns the global (page, slot) encoded position.  On an
        accounting-only pool (``materialize=False``) the tensors may be
        omitted; only pointers and byte counters advance."""
        page, slot = self.next_slot(zone)
        if self.materialize:
            if layer_k is None or layer_v is None:
                raise ValueError("materialized pool needs K/V tensors")
            self.put(slice(None), page, slot, layer_k, layer_v)
        return self.advance(zone)

    def read_token(self, zone: KVZone, idx: int):
        """Read back one written token's (K, V) ([L, KV, D] numpy each)."""
        if not self.materialize:
            raise ValueError("accounting-only pool holds no data")
        if not 0 <= idx < zone.write_ptr:
            raise IndexError(f"token {idx} not written (ptr={zone.write_ptr})")
        page = zone.pages[idx // self.page_size]
        slot = idx % self.page_size
        return (_host(self.k[:, page, slot]), _host(self.v[:, page, slot]))

    def copy_zone_from(self, other: "PagedPool", src: KVZone,
                       dst: KVZone) -> int:
        """Migrate a zone's written tokens between tiers. Returns bytes
        moved.  Only pages covered by the source write pointer move (a
        partially-filled zone does not pay for — or corrupt — its empty
        tail), and the destination must have room for the written span."""
        if self.page_size != other.page_size:
            raise ValueError(
                f"page-size mismatch: {self.name}={self.page_size} "
                f"vs {other.name}={other.page_size}")
        if src.write_ptr > len(dst.pages) * self.page_size:
            raise ValueError(
                f"zone copy overflow: {src.write_ptr} tokens into "
                f"{len(dst.pages)}x{self.page_size}-token zone")
        n_pages = -(-src.write_ptr // self.page_size)   # ceil
        if n_pages and self.materialize and other.materialize:
            # one copy per tensor for all the zone's written pages
            sp, dp = src.pages[:n_pages], dst.pages[:n_pages]
            for mine, theirs in ((self.k, other.k), (self.v, other.v)):
                if isinstance(mine, np.ndarray):
                    mine[:, dp] = _host(theirs[:, sp])
                else:
                    mine[:, dp] = torch.as_tensor(theirs[:, sp]).to(
                        mine.device)
        moved = 0
        for i in range(n_pages):
            tokens = min(self.page_size, src.write_ptr - i * self.page_size)
            moved += tokens * other.token_bytes
        dst.write_ptr = src.write_ptr
        other.bytes_read += moved
        self.bytes_written += moved
        return moved
