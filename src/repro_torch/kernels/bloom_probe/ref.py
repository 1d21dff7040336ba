"""Plain PyTorch version of the Bloom probe and of filter construction.

Hash family (shared bit-for-bit with the CUDA kernels and the numpy path
in ``repro_torch.lsm.filters``): keys are hashed with the splitmix64
finaliser, the hash is split into uint32 halves ``lo`` / ``hi`` (hi
forced odd), and probe position ``i`` is Kirsch-Mitzenmacher double
hashing ``(lo + i*hi) mod (num_words*32)`` in wrapping uint32 arithmetic.
The single-filter probe takes the halves hashed by the caller; the pairs
probe takes raw keys and hashes them itself (:func:`mix64`), as its
kernel does on the card.

PyTorch on the CPU has no uint32 or uint64 ``+``, ``%`` or ``>>``, so
uint32 values travel as int32 tensors and uint64 keys as int64 tensors
(the same bits).  uint32 steps compute in int64 with ``& 0xFFFFFFFF``
masking; the 64-bit hash computes in int64, whose multiplies wrap like
uint64 ones, with every right shift made logical by masking off the
copied sign bits.  The k probe positions are formed at once as an
[N, k] tensor; a key hits when all its k bits are set.

This is the version the wrappers in ``ops`` take for tensors on the CPU,
and the one ``chip_smoke.py`` holds the kernels against on the card.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
# splitmix64's multipliers as int64 (the same 64 bits)
_C1 = 0xBF58476D1CE4E5B9 - 2**64
_C2 = 0x94D049BB133111EB - 2**64


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor holding uint32 bits -> int64 tensor of the uint32 value."""
    return x.to(torch.int64) & _M32


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def mix64(keys: torch.Tensor) -> torch.Tensor:
    """splitmix64 finaliser of uint64 keys held as int64 -> int64 hashes
    with the same bits as ``repro_torch.lsm.sstable._mix64``."""
    x = keys.to(torch.int64)
    x = (x ^ _shr(x, 30)) * _C1
    x = (x ^ _shr(x, 27)) * _C2
    return x ^ _shr(x, 31)


def split_hash(keys: torch.Tensor):
    """(lo, hi) uint32 halves of the keys' hashes, as int64 values."""
    h = mix64(keys)
    return h & _M32, _shr(h, 32) | 1


def _positions(lo: torch.Tensor, hi: torch.Tensor, nbits,
               k_hashes: int) -> torch.Tensor:
    """[N, k] probe positions ``((lo + i*hi) mod 2**32) mod nbits``."""
    i = torch.arange(k_hashes, dtype=torch.int64, device=lo.device)
    raw = (_u32(lo)[:, None] + i[None, :] * _u32(hi)[:, None]) & _M32
    return raw % nbits


def _gather_bits(words: torch.Tensor, pos: torch.Tensor,
                 word_off=0) -> torch.Tensor:
    """Bit ``pos`` of the packed image: word ``pos >> 5``, bit ``pos & 31``."""
    w = _u32(words[(pos >> 5) + word_off])
    return (w >> (pos & 31)) & 1


def _to_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 tensor of uint32 values -> int32 tensor with the same bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def build_filter(lo: torch.Tensor, hi: torch.Tensor, num_words: int,
                 k_hashes: int = 7) -> torch.Tensor:
    """Insert pre-hashed keys (int32 ``lo``/``hi``) into a packed bit array.

    Bits are set on a flat bool array (duplicate scatter indices all write
    True) and packed 32 to a word, bit ``b`` of word ``w`` at flat index
    ``w*32 + b``.  Returns int32[num_words] holding the uint32 words."""
    nbits = (num_words * 32) & _M32
    flat = torch.zeros(num_words * 32, dtype=torch.bool, device=lo.device)
    flat[_positions(lo, hi, nbits, k_hashes).reshape(-1)] = True
    lanes = flat.reshape(num_words, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=lo.device)
    return _to_int32_bits((lanes << shifts).sum(dim=1))


def bloom_probe_ref(lo: torch.Tensor, hi: torch.Tensor, bits: torch.Tensor,
                    k_hashes: int = 7) -> torch.Tensor:
    """Probe one packed filter (int32[W]) with N pre-hashed keys
    -> int32[N] hit mask."""
    nbits = (bits.shape[0] * 32) & _M32
    pos = _positions(lo, hi, nbits, k_hashes)
    return _gather_bits(bits, pos).all(dim=1).to(torch.int32)


def bloom_probe_pairs_ref(keys: torch.Tensor, pair_key: torch.Tensor,
                          pair_slot: torch.Tensor, pair_k: torch.Tensor,
                          slot_off: torch.Tensor, slot_words: torch.Tensor,
                          words: torch.Tensor) -> torch.Tensor:
    """Pairs probe -> uint8[P] hit mask.

    Pair ``p`` hashes ``keys[pair_key[p]]`` (uint64 bits in int64) and
    tests its first ``pair_k[p]`` positions in the filter of slot
    ``pair_slot[p]``: ``slot_words`` words from ``slot_off`` in the
    concatenated image ``words`` (``num_words * 32`` wraps as uint32, as
    in the reference).  The batched LSM read path's shape: every
    candidate pair of a batch, over all levels, in one call."""
    p = pair_key.shape[0]
    if p == 0:
        return torch.zeros(0, dtype=torch.uint8, device=words.device)
    lo, hi = split_hash(keys[pair_key.long()])
    slot = pair_slot.long()
    nbits = ((slot_words[slot].to(torch.int64) * 32) & _M32)[:, None]
    k = pair_k.to(torch.int64)
    kmax = int(k.max())
    i = torch.arange(kmax, dtype=torch.int64, device=words.device)
    pos = ((lo[:, None] + i[None, :] * hi[:, None]) & _M32) % nbits
    bit = _gather_bits(words, pos, slot_off[slot][:, None])
    bit = bit | (i[None, :] >= k[:, None]).to(torch.int64)
    return bit.all(dim=1).to(torch.uint8)
