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


def probe(lo: torch.Tensor, hi: torch.Tensor, bits: torch.Tensor,
          k: int = 7) -> torch.Tensor:
    """Probe one packed filter (int32[W]) with int32 hash halves
    -> int32[N] hit mask."""
    if bits.device.type == "cuda":
        return kernel.bloom_probe(lo, hi, bits, k)
    if bits.device.type != "cpu":
        raise ValueError(f"no Bloom probe for tensors on {bits.device}")
    return bloom_probe_ref(lo, hi, bits, k)


def probe_pairs(lo: torch.Tensor, hi: torch.Tensor, word_off: torch.Tensor,
                num_words: torch.Tensor, bits_concat: torch.Tensor,
                k: int = 7) -> torch.Tensor:
    """Ragged (key x filter) pairs probe -> int32[P] hit mask."""
    if bits_concat.device.type == "cuda":
        return kernel.bloom_probe_pairs(lo, hi, word_off, num_words,
                                        bits_concat, k)
    if bits_concat.device.type != "cpu":
        raise ValueError(f"no Bloom probe for tensors on {bits_concat.device}")
    return bloom_probe_pairs_ref(lo, hi, word_off, num_words, bits_concat, k)
