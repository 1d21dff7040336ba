"""Key→shard routing policies for the sharded store.

Two pluggable routers share one tiny protocol:

* ``route(key) -> int`` — owning shard of a point key.
* ``shards_for_range(lo, hi) -> list[int]`` — shards a range op must
  consult.
* ``covering_segments(lo, hi) -> [(lo, hi, owner)]`` — the range split
  into maximal same-owner pieces (range router: exact ownership; hash
  router: every shard owns a slice of every range).

``HashRouter`` scatters keys uniformly with a splitmix64-style mixer —
perfect balance, no locality, and therefore no online splitting (a hash
shard has no contiguous range to hand off).  ``RangeRouter`` owns
contiguous key segments and supports ``reassign(lo, hi, dst)``, the
atomic routing flip at the end of an online split
(:meth:`repro_torch.cluster.ShardedDB.split`).  Both are plain Python state
mutated between DES events, so a flip is atomic in virtual time by
construction.
"""
from __future__ import annotations

from bisect import bisect_right, insort
from typing import List, Tuple

INF = float("inf")

_MASK = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer: deterministic, platform-independent mixing
    (``hash(int)`` is identity in CPython — useless for sharding)."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


class HashRouter:
    """Uniform scatter routing; static by design (no contiguous ranges)."""

    kind = "hash"

    def __init__(self, n_shards: int):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1: {n_shards}")
        self.n = int(n_shards)

    def route(self, key: int) -> int:
        if self.n == 1:
            return 0
        return _mix64(int(key)) % self.n

    def shards_for_range(self, lo: int, hi) -> List[int]:
        return list(range(self.n))

    def covering_segments(self, lo: int, hi) -> List[Tuple[int, float, int]]:
        # every shard holds a scatter of the range; callers fall back to
        # consulting all shards with the full range
        return [(lo, hi, s) for s in range(self.n)]

    def reassign(self, lo: int, hi, dst: int) -> None:
        raise NotImplementedError(
            "hash routing has no contiguous ranges to reassign; "
            "use routing='range' for online splits")

    def segments_of(self, shard: int) -> List[Tuple[int, float]]:
        return []

    def describe(self) -> dict:
        return {"kind": "hash", "shards": self.n}


class RangeRouter:
    """Contiguous key segments with atomic online reassignment.

    Ownership is a sorted boundary list: ``bounds[i]`` starts the i-th
    segment, owned by ``owners[i]``; the last segment extends to +inf so
    frontier inserts (YCSB ``latest`` / insert-heavy mixes) always route.
    Initial layout splits ``[0, key_space)`` evenly across shards.
    """

    kind = "range"

    def __init__(self, n_shards: int, key_space: int):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1: {n_shards}")
        if key_space < n_shards:
            raise ValueError(
                f"key_space {key_space} smaller than shard count {n_shards}")
        self.n = int(n_shards)
        self.key_space = int(key_space)
        step = key_space // n_shards
        self.bounds: List[int] = [i * step for i in range(n_shards)]
        self.owners: List[int] = list(range(n_shards))

    # -- lookup ---------------------------------------------------------
    def _seg(self, key: int) -> int:
        return bisect_right(self.bounds, int(key)) - 1

    def route(self, key: int) -> int:
        return self.owners[self._seg(key)]

    def _seg_hi(self, i: int):
        return self.bounds[i + 1] if i + 1 < len(self.bounds) else INF

    def covering_segments(self, lo: int, hi) -> List[Tuple[int, float, int]]:
        """Maximal same-owner pieces of ``[lo, hi)`` (``hi`` may be INF),
        clipped to the query range."""
        if hi is not INF and hi <= lo:
            return []
        out: List[Tuple[int, float, int]] = []
        i = self._seg(lo)
        while i < len(self.bounds) and (hi is INF or self.bounds[i] < hi):
            s_lo = max(self.bounds[i], lo)
            s_hi = self._seg_hi(i) if hi is INF else min(self._seg_hi(i), hi)
            if not out or out[-1][2] != self.owners[i]:
                out.append((s_lo, s_hi, self.owners[i]))
            else:  # merge adjacent same-owner segments of the query
                out[-1] = (out[-1][0], s_hi, self.owners[i])
            i += 1
        return out

    def shards_for_range(self, lo: int, hi) -> List[int]:
        seen: List[int] = []
        for _, _, s in self.covering_segments(lo, hi):
            if s not in seen:
                seen.append(s)
        return seen

    def segments_of(self, shard: int) -> List[Tuple[int, float]]:
        return [(self.bounds[i], self._seg_hi(i))
                for i in range(len(self.bounds)) if self.owners[i] == shard]

    # -- reassignment ---------------------------------------------------
    def _split_at(self, key: int) -> None:
        i = self._seg(key)
        if self.bounds[i] != key:
            insort(self.bounds, int(key))
            self.owners.insert(i + 1, self.owners[i])

    def reassign(self, lo: int, hi, dst: int) -> None:
        """Atomically hand ``[lo, hi)`` (``hi`` may be INF) to ``dst``.
        Plain list surgery between DES events — no sim interaction, so
        in-flight ops observe either the old or the new map, never a mix."""
        if not (0 <= dst < self.n):
            raise ValueError(f"no such shard: {dst}")
        if hi is not INF and hi <= lo:
            raise ValueError(f"empty range [{lo}, {hi})")
        self._split_at(int(lo))
        if hi is not INF:
            self._split_at(int(hi))
        for i in range(len(self.bounds)):
            if self.bounds[i] >= lo and (hi is INF or self._seg_hi(i) <= hi):
                self.owners[i] = dst
        self._coalesce()

    def _coalesce(self) -> None:
        bounds, owners = [self.bounds[0]], [self.owners[0]]
        for b, o in zip(self.bounds[1:], self.owners[1:]):
            if o != owners[-1]:
                bounds.append(b)
                owners.append(o)
        self.bounds, self.owners = bounds, owners

    def describe(self) -> dict:
        return {"kind": "range", "shards": self.n,
                "bounds": list(self.bounds), "owners": list(self.owners)}
