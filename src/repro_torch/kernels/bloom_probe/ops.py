"""Public Bloom-probe entry points: the kernel for CUDA tensors, the plain
version for CPU tensors.

The choice follows only the device of the filter image: a CUDA image
launches the CUDA kernel (which raises on anything it does not take), a
CPU image takes the plain PyTorch version in ``ref``.  Nothing falls back
from one to the other.
"""
from __future__ import annotations

import torch

from . import bloom_probe as kernel
from .ref import bloom_probe_pairs_ref, bloom_probe_ref


def _route(words: torch.Tensor) -> str:
    if words.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no Bloom probe for tensors on {words.device}")
    return words.device.type


def probe(lo: torch.Tensor, hi: torch.Tensor, bits: torch.Tensor,
          k: int = 7) -> torch.Tensor:
    """Probe one packed filter (int32[W]) with int32 hash halves
    -> int32[N] hit mask."""
    if _route(bits) == "cuda":
        return kernel.bloom_probe(lo, hi, bits, k)
    return bloom_probe_ref(lo, hi, bits, k)


def probe_pairs(keys: torch.Tensor, pair_key: torch.Tensor,
                pair_slot: torch.Tensor, pair_k: torch.Tensor,
                slot_off: torch.Tensor, slot_words: torch.Tensor,
                words: torch.Tensor) -> torch.Tensor:
    """(key x filter) pairs probe, keys hashed inside -> uint8[P] hit
    mask (operands as ``ref.bloom_probe_pairs_ref``)."""
    args = (keys, pair_key, pair_slot, pair_k, slot_off, slot_words, words)
    if _route(words) == "cuda":
        return kernel.bloom_probe_pairs(*args)
    return bloom_probe_pairs_ref(*args)
