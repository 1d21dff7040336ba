"""Real packed Bloom filters with one unified hash family (splitmix64).

Every SST carries a packed uint32 bit array built from its key set
(``filter_bits_per_key`` bits per key, ``k = round(bits_per_key * ln 2)``
probe positions).  The hash family is shared across every implementation:

* keys are hashed with the splitmix64 finaliser (``sstable._mix64``): on
  the host in numpy to build filters and for the single-filter probe, on
  the card inside the pairs kernel;
* the 64-bit hash is split into two uint32 halves ``lo = h & 0xffffffff``
  and ``hi = (h >> 32) | 1`` (forced odd so the probe stride cycles);
* probe position ``i`` is Kirsch-Mitzenmacher double hashing,
  ``pos_i = (lo + i * hi) mod (num_words * 32)``, computed in wrapping
  uint32 arithmetic — bit-for-bit identical in the numpy path here, the
  plain PyTorch version (``repro_torch.kernels.bloom_probe.ref``) and the
  CUDA kernels (``repro_torch.kernels.bloom_probe``).

Filters are built on the host with numpy.  A store probes against one
:class:`StoreImage` of all its filters with a slot per SST, through a
:class:`Prober`, on one of two routes (``impl``): ``"torch"`` (the
default; the image lives on the store's torch device, the CUDA kernels on
a card, the plain PyTorch version on the CPU) or ``"numpy"`` (the numpy
twins here).  Across the routes the hit masks are identical
(``tests/test_torch_filters.py``).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.bloom_probe import bloom_probe as kernel
from ..kernels.bloom_probe import ops
from .sstable import SST, _mix64

_LN2 = math.log(2.0)
_M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1
IMPLS = ("numpy", "torch")


# ----------------------------------------------------------------------
# hashing
# ----------------------------------------------------------------------
def split_hash(keys) -> Tuple[np.ndarray, np.ndarray]:
    """splitmix64 the uint64 keys, split into (lo, hi) uint32 halves.

    ``hi`` is forced odd so the double-hashing stride is coprime with any
    power-of-two and never collapses the k probe positions onto one bit.
    """
    keys = np.atleast_1d(np.asarray(keys, dtype=np.uint64))
    h = _mix64(keys)
    lo = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (h >> np.uint64(32)).astype(np.uint32) | np.uint32(1)
    return lo, hi


def _split_hash_int(key: int) -> Tuple[int, int]:
    """Python-int twin of :func:`split_hash` for the per-key read path."""
    x = key & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    x = x ^ (x >> 31)
    return x & _M32, (x >> 32) | 1


def filter_params(num_keys: int, bits_per_key: int) -> Tuple[int, int]:
    """(num_words, k_hashes) for a key count at a bits-per-key budget."""
    nbits = max(1, int(num_keys)) * max(1, int(bits_per_key))
    num_words = max(1, -(-nbits // 32))
    k = max(1, min(16, int(round(bits_per_key * _LN2))))
    return num_words, k


# ----------------------------------------------------------------------
# pure-numpy build + probe
# ----------------------------------------------------------------------
def build_filter_np(lo: np.ndarray, hi: np.ndarray, num_words: int,
                    k_hashes: int) -> np.ndarray:
    """Set k bits per key on a packed uint32 array (word ``w`` bit ``b``
    lives at flat index ``w*32 + b``)."""
    nbits = np.uint32(num_words * 32)
    flat = np.zeros(num_words * 32, dtype=bool)
    with np.errstate(over="ignore"):
        for i in range(k_hashes):
            pos = (lo + np.uint32(i) * hi) % nbits
            flat[pos.astype(np.int64)] = True
    lanes = flat.reshape(num_words, 32).astype(np.uint32)
    weights = np.uint32(1) << np.arange(32, dtype=np.uint32)
    return np.sum(lanes * weights, axis=-1, dtype=np.uint32)


def probe_np(lo: np.ndarray, hi: np.ndarray, bits: np.ndarray,
             k_hashes: int) -> np.ndarray:
    """Probe one filter with a batch of pre-hashed keys -> bool[N]."""
    nbits = np.uint32(bits.shape[0] * 32)
    hit = np.ones(lo.shape, dtype=bool)
    with np.errstate(over="ignore"):
        for i in range(k_hashes):
            pos = (lo + np.uint32(i) * hi) % nbits
            w = bits[(pos >> np.uint32(5)).astype(np.int64)]
            hit &= ((w >> (pos & np.uint32(31))) & np.uint32(1)).astype(bool)
    return hit


def probe_slots_np(keys: np.ndarray, pair_key: np.ndarray,
                   pair_slot: np.ndarray, pair_k: np.ndarray,
                   slot_off: np.ndarray, slot_words: np.ndarray,
                   words: np.ndarray) -> np.ndarray:
    """The pairs kernel's function in numpy: pair ``p`` hashes
    ``keys[pair_key[p]]`` and tests ``pair_k[p]`` positions in the filter
    of slot ``pair_slot[p]`` (``slot_words`` words from ``slot_off`` in
    ``words``) -> bool[P]."""
    lo, hi = split_hash(keys)
    key = np.asarray(pair_key, dtype=np.int64)
    slot = np.asarray(pair_slot, dtype=np.int64)
    k = np.asarray(pair_k, dtype=np.int64)
    lo, hi = lo[key], hi[key]
    nbits = slot_words[slot].astype(np.uint32) * np.uint32(32)
    off = slot_off[slot].astype(np.int64)
    hit = np.ones(len(key), dtype=bool)
    with np.errstate(over="ignore"):
        for i in range(int(k.max()) if len(k) else 0):
            pos = (lo + np.uint32(i) * hi) % nbits
            w = words[off + (pos >> np.uint32(5)).astype(np.int64)]
            bit = ((w >> (pos & np.uint32(31))) & np.uint32(1)).astype(bool)
            hit &= bit | (i >= k)
    return hit


def probe_one_np(key: int, bits: np.ndarray, k_hashes: int) -> bool:
    """Scalar probe in plain python ints — the per-key `get` path of the
    numpy route; bitwise-identical to :func:`probe_np` on one key."""
    lo, hi = _split_hash_int(key)
    nbits = bits.shape[0] * 32
    for i in range(k_hashes):
        pos = ((lo + i * hi) & _M32) % nbits
        if not (int(bits[pos >> 5]) >> (pos & 31)) & 1:
            return False
    return True


# ----------------------------------------------------------------------
# the store image and the probe routes
# ----------------------------------------------------------------------
def resolve_impl(impl: str) -> str:
    """Validate a probe route name: ``"torch"`` or ``"numpy"``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown filter impl {impl!r}; one of {IMPLS}")
    return impl


def _int32_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 numpy array -> int32 tensor with the same bits on ``device``."""
    a = np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(a).to(device)


def device_words(words: np.ndarray, device) -> torch.Tensor:
    """Upload a packed uint32 filter image as an int32 tensor."""
    return _int32_tensor(words, torch.device(device))


class StoreImage:
    """Every filtered SST of a store in one image, with a slot table: slot
    ``slot[sid]`` is that SST's filter, ``slot_words`` words from
    ``slot_off``, built with ``slot_k`` probes.  The slot table is kept on
    the host (numpy) for building a call's operands.  On the numpy route
    (``device`` None) ``words`` is a uint32 array; on the torch route an
    int32 tensor on ``device``, with the slot table beside it in
    ``tensors`` (``slot_off``, ``slot_words``, ``words``) and, on a CUDA
    device, ``resident``: the same tensors as a ``kernel.Image``, checked
    once here."""

    __slots__ = ("slot", "slot_off", "slot_words", "slot_k", "words",
                 "tensors", "resident")

    def __init__(self, chunks: list, entries: Sequence[Tuple[int, int, int,
                                                             int]],
                 device: Optional[torch.device] = None):
        """``chunks``: the levels' images in order; ``entries``: (sid,
        word offset in the joined image, num_words, k) per filtered SST."""
        self.slot = {e[0]: s for s, e in enumerate(entries)}
        self.slot_off = np.array([e[1] for e in entries], dtype=np.int64)
        self.slot_words = np.array([e[2] for e in entries], dtype=np.int32)
        self.slot_k = np.array([e[3] for e in entries], dtype=np.uint8)
        self.tensors = self.resident = None
        if device is None:
            self.words = (np.concatenate(chunks) if chunks
                          else np.zeros(0, dtype=np.uint32))
            return
        self.words = (torch.cat(chunks) if chunks
                      else torch.zeros(0, dtype=torch.int32, device=device))
        self.tensors = (torch.from_numpy(self.slot_off).to(device),
                        torch.from_numpy(self.slot_words).to(device),
                        self.words)
        if device.type == "cuda":
            self.resident = kernel.Image(self.words, *self.tensors[:2])

    def slots_of(self, ssts: Sequence[SST]) -> np.ndarray:
        """int32 slot of each SST, -1 for an SST without a filter."""
        return np.fromiter((self.slot.get(s.sid, -1) for s in ssts),
                           np.int32, len(ssts))

    def filter_words(self, slot: int):
        """Slot ``slot``'s filter as a view of the image."""
        off = int(self.slot_off[slot])
        return self.words[off:off + int(self.slot_words[slot])]


def _aligned(n: int) -> int:
    return -(-n // 16) * 16


class Prober:
    """Runs a store's probe calls on the route of the image it is given:
    numpy for a numpy image, the plain PyTorch version (``ops``) for a CPU
    tensor image, the CUDA kernels for a resident image.

    On the card every call goes through one pinned host staging buffer and
    one device buffer, kept for the store's life and grown by doubling
    (``cudaHostAlloc`` takes milliseconds, so never per call): the call's
    operands are packed into the pinned buffer, one ``non_blocking`` copy
    moves them to the card, the kernel writes into the device buffer, one
    ``non_blocking`` copy brings the hit mask back into pinned memory, and
    one synchronise of the stream precedes the read.  The next call writes
    the pinned buffer only after that synchronise, so reuse is safe on one
    stream."""

    def __init__(self):
        self._cap, self._index = 0, None
        self._host = self._host_np = self._dev = None
        self._dev_ptr = 0

    def _reserve(self, nbytes: int, image) -> None:
        if nbytes <= self._cap and self._index == image.index:
            return
        cap = max(4096, self._cap if self._index == image.index else 0)
        while cap < nbytes:
            cap *= 2
        self._host = torch.empty(cap, dtype=torch.uint8, pin_memory=True)
        self._host_np = self._host.numpy()
        self._dev = torch.empty(cap, dtype=torch.uint8, device=image.device)
        self._dev_ptr, self._cap, self._index = \
            self._dev.data_ptr(), cap, image.index

    def _round_trip(self, res, n_in: int, out: int, n_out: int,
                    launch) -> np.ndarray:
        """Copy the ``n_in`` packed bytes to the card, ``launch(base)`` (the
        device buffer's address), copy ``n_out`` result bytes at offset
        ``out`` back and wait for them: a view of the pinned buffer, valid
        until the next call."""
        self._dev[:n_in].copy_(self._host[:n_in], non_blocking=True)
        launch(self._dev_ptr)
        self._host[out:out + n_out].copy_(self._dev[out:out + n_out],
                                          non_blocking=True)
        torch.cuda.current_stream(res.index).synchronize()
        return self._host_np[out:out + n_out]

    def probe_pairs(self, image: StoreImage, keys: np.ndarray,
                    pair_key: np.ndarray, pair_slot: np.ndarray,
                    pair_k: np.ndarray) -> np.ndarray:
        """Hits of pair ``p``: ``keys[pair_key[p]]`` (uint64) probed with
        ``pair_k[p]`` (uint8) positions in slot ``pair_slot[p]`` (int32)'s
        filter -> bool[P].  Keys are hashed once each, on the card on the
        torch route."""
        res = image.resident
        if res is None:
            if image.tensors is None:
                return probe_slots_np(keys, pair_key, pair_slot, pair_k,
                                      image.slot_off, image.slot_words,
                                      image.words)
            t = torch.from_numpy
            out = ops.probe_pairs(t(keys.view(np.int64)), t(pair_key),
                                  t(pair_slot), t(pair_k), *image.tensors)
            return out.numpy().astype(bool)
        n, p = len(keys), len(pair_key)
        a = 8 * n
        b = a + 4 * p
        c = b + 4 * p
        d = c + p
        o = _aligned(d)
        self._reserve(o + p, res)
        h = self._host_np
        h[:a].view(np.uint64)[:] = keys
        h[a:b].view(np.int32)[:] = pair_key
        h[b:c].view(np.int32)[:] = pair_slot
        h[c:d] = pair_k
        return self._round_trip(res, d, o, p, lambda base: kernel.launch_pairs(
            res, n, p, base, base + a, base + b, base + c, base + o)
        ).astype(bool)

    def probe(self, image: StoreImage, slot: int, lo: np.ndarray,
              hi: np.ndarray, k: int) -> np.ndarray:
        """Probe slot ``slot``'s filter alone with keys hashed on the host
        (uint32 halves ``lo``, ``hi``) and ``k`` positions -> bool[N]."""
        res = image.resident
        if res is None:
            bits = image.filter_words(slot)
            if image.tensors is None:
                return probe_np(lo, hi, bits, k)
            out = ops.probe(_int32_tensor(lo, bits.device),
                            _int32_tensor(hi, bits.device), bits, k)
            return out.numpy().astype(bool)
        n = len(lo)
        o = _aligned(8 * n)
        self._reserve(o + 4 * n, res)
        h = self._host_np
        h[:4 * n].view(np.uint32)[:] = lo
        h[4 * n:8 * n].view(np.uint32)[:] = hi
        off, nw = int(image.slot_off[slot]), int(image.slot_words[slot])
        return self._round_trip(res, 8 * n, o, 4 * n, lambda base:
                                kernel.launch_single(res, off, nw, n, base,
                                                     base + 4 * n, k,
                                                     base + o)
                                ).view(np.int32).astype(bool)


# ----------------------------------------------------------------------
# SST attachment
# ----------------------------------------------------------------------
def attach_filter(sst: SST, bits_per_key: int) -> None:
    """Build and attach the packed filter for an SST's key set."""
    num_words, k = filter_params(sst.num_objs, bits_per_key)
    lo, hi = split_hash(sst.keys)
    sst.filter_words = build_filter_np(lo, hi, num_words, k)
    sst.filter_k = k


def concat_filters(ssts: Sequence[SST]) -> Tuple[np.ndarray, dict]:
    """Concatenate distinct SSTs' filter words for the pairs probe.

    Returns (bits_concat, {sid: (word_off, num_words)}).
    """
    offsets: dict = {}
    chunks: List[np.ndarray] = []
    off = 0
    for sst in ssts:
        if sst.sid in offsets or sst.filter_words is None:
            continue
        w = sst.filter_words
        offsets[sst.sid] = (off, len(w))
        chunks.append(w)
        off += len(w)
    bits = (np.concatenate(chunks) if chunks
            else np.zeros(0, dtype=np.uint32))
    return bits, offsets


def from_reference_sst_arrays(keys: np.ndarray, tombs: np.ndarray,
                              filter_words, filter_k: int, *, sid: int = 0,
                              level: int = 0, obj_size: int = 1024,
                              block_size: int = 4096) -> SST:
    """Build the port's SST from a reference SST's numpy arrays (keys,
    tombstones, packed filter words, probe count), copying them, so the two
    packages probe identical filter images."""
    words = (None if filter_words is None
             else np.array(filter_words, dtype=np.uint32))
    return SST(sid=sid, level=level,
               keys=np.array(keys, dtype=np.uint64),
               tombs=np.array(tombs, dtype=np.bool_),
               obj_size=obj_size, block_size=block_size,
               filter_words=words, filter_k=int(filter_k))
