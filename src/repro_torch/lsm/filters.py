"""Real packed Bloom filters with one unified hash family (splitmix64).

Every SST carries a packed uint32 bit array built from its key set
(``filter_bits_per_key`` bits per key, ``k = round(bits_per_key * ln 2)``
probe positions).  The hash family is shared across every implementation:

* keys are pre-hashed **host-side** in numpy with the splitmix64
  finaliser (``sstable._mix64``), as the reference does;
* the 64-bit hash is split into two uint32 halves ``lo = h & 0xffffffff``
  and ``hi = (h >> 32) | 1`` (forced odd so the probe stride cycles);
* probe position ``i`` is Kirsch-Mitzenmacher double hashing,
  ``pos_i = (lo + i * hi) mod (num_words * 32)``, computed in wrapping
  uint32 arithmetic — bit-for-bit identical in the numpy path here, the
  plain PyTorch version (``repro_torch.kernels.bloom_probe.ref``) and the
  CUDA kernel (``repro_torch.kernels.bloom_probe``).

Filters are built on the host with numpy.  Probes take one of two routes
(``impl``): ``"torch"`` (the default) hands int32 tensors to
``repro_torch.kernels.bloom_probe.ops`` on the device of the filter
image, ``"numpy"`` runs the numpy path.  Across the two the hit masks are
identical (``tests/test_torch_filters.py``).
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

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


def probe_pairs_np(lo: np.ndarray, hi: np.ndarray, word_off: np.ndarray,
                   num_words: np.ndarray, bits_concat: np.ndarray,
                   k_hashes: int) -> np.ndarray:
    """Probe P (key x filter) pairs in one vectorized call.

    ``bits_concat`` is the concatenation of every candidate SST's filter
    words; pair ``p`` probes the ``num_words[p]`` words starting at
    ``word_off[p]``.  This is the ragged form the batched read path needs:
    each key may probe a different filter per level.
    """
    nbits = (num_words.astype(np.uint32) * np.uint32(32))
    off = word_off.astype(np.int64)
    hit = np.ones(lo.shape, dtype=bool)
    with np.errstate(over="ignore"):
        for i in range(k_hashes):
            pos = (lo + np.uint32(i) * hi) % nbits
            w = bits_concat[off + (pos >> np.uint32(5)).astype(np.int64)]
            hit &= ((w >> (pos & np.uint32(31))) & np.uint32(1)).astype(bool)
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
# torch route (kernel package): filter images live on a torch device
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


def probe(lo: np.ndarray, hi: np.ndarray, bits, k_hashes: int,
          impl: str = "torch") -> np.ndarray:
    """Probe one filter (numpy uint32 words, or an int32 tensor from
    :func:`device_words` under ``impl="torch"``) -> bool[N].  Under
    ``"torch"`` the hash halves travel to the image's device in one copy."""
    if resolve_impl(impl) == "torch":
        n = len(lo)
        host = np.empty(2 * n, dtype=np.uint32)
        host[:n], host[n:] = lo, hi
        buf = _int32_tensor(host, bits.device)
        out = ops.probe(buf[:n], buf[n:], bits, k_hashes)
        return out.cpu().numpy().astype(bool)
    return probe_np(lo, hi, bits, k_hashes)


def probe_pairs(lo, hi, word_off, num_words, bits_concat, k_hashes,
                impl: str = "torch") -> np.ndarray:
    """Ragged pairs probe on the selected route.  Under ``"torch"`` the
    image ``bits_concat`` is a device tensor (:func:`device_words`); the
    per-call arrays go to its device in one copy (``word_off`` as int64,
    ``lo``, ``hi`` and ``num_words`` as int32) and only the hit mask comes
    back."""
    if resolve_impl(impl) == "torch":
        n = len(lo)
        host = np.empty(5 * n, dtype=np.uint32)
        host[:2 * n].view(np.int64)[:] = word_off
        host[2 * n:3 * n], host[3 * n:4 * n] = lo, hi
        host[4 * n:] = num_words
        buf = _int32_tensor(host, bits_concat.device)
        out = ops.probe_pairs(buf[2 * n:3 * n], buf[3 * n:4 * n],
                              buf[:2 * n].view(torch.int64), buf[4 * n:],
                              bits_concat, k_hashes)
        return out.cpu().numpy().astype(bool)
    return probe_pairs_np(lo, hi, word_off, num_words, bits_concat, k_hashes)


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
