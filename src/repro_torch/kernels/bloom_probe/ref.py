"""Plain PyTorch version of the Bloom probe and of filter construction.

Hash family (shared bit-for-bit with the CUDA kernel and the numpy path
in ``repro_torch.lsm.filters``): keys are splitmix64-hashed host-side in
numpy, the hash is split into uint32 halves ``lo`` / ``hi`` (hi forced
odd), and probe position ``i`` is Kirsch-Mitzenmacher double hashing
``(lo + i*hi) mod (num_words*32)`` in wrapping uint32 arithmetic.

PyTorch on the CPU has no uint32 ``+``, ``%`` or ``>>``, so uint32 values
travel as int32 tensors (the same bits) and every step here computes in
int64 with ``& 0xFFFFFFFF`` masking, which reproduces the wrapping uint32
results exactly.  The k probe positions are formed at once as an [N, k]
tensor; a key hits when all k bits are set.

This is the version the wrappers in ``ops`` take for tensors on the CPU,
and the one ``chip_smoke.py`` holds the kernel against on the card.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor holding uint32 bits -> int64 tensor of the uint32 value."""
    return x.to(torch.int64) & _M32


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


def bloom_probe_pairs_ref(lo: torch.Tensor, hi: torch.Tensor,
                          word_off: torch.Tensor, num_words: torch.Tensor,
                          bits_concat: torch.Tensor,
                          k_hashes: int = 7) -> torch.Tensor:
    """Ragged (key x filter) pairs probe -> int32[P] hit mask.

    Pair ``p`` tests the filter of ``num_words[p]`` words starting at
    ``word_off[p]`` in the concatenated image ``bits_concat``: the batched
    LSM read path's shape (one call over every candidate pair of a
    level)."""
    nbits = ((num_words.to(torch.int64) * 32) & _M32)[:, None]
    pos = _positions(lo, hi, nbits, k_hashes)
    off = word_off.to(torch.int64)[:, None]
    return _gather_bits(bits_concat, pos, off).all(dim=1).to(torch.int32)
