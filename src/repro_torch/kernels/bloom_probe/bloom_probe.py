"""Build and launch the CUDA Bloom-probe kernels (``csrc/bloom_probe.cu``).

The source is compiled at first use with nvcc into a shared library and
bound with ctypes (``kernels/_build.py``).

Both wrappers take CUDA tensors only, check device, dtype, contiguity and
shapes, allocate the int32 output with ``torch.empty``, launch on the
current stream without synchronising, and raise if the launch was
refused.  ``launches`` counts the kernel launches of each wrapper.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from .. import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "bloom_probe.cu"
_VP, _LL = ctypes.c_void_p, ctypes.c_longlong
SIGNATURES = {
    "bloom_probe": [_VP, _VP, _VP, _LL, _LL, ctypes.c_int, _VP, _VP],
    "bloom_probe_pairs": [_VP, _VP, _VP, _VP, _VP, _LL, ctypes.c_int,
                          _VP, _VP],
}

launches: Dict[str, int] = {"bloom_probe": 0, "bloom_probe_pairs": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def load() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its signatures."""
    return _build.load(SOURCE, SIGNATURES)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           device: torch.device, n: Optional[int] = None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor")
    if n is not None and t.shape[0] != n:
        raise ValueError(f"{name} has {t.shape[0]} entries, expected {n}")


def bloom_probe(lo: torch.Tensor, hi: torch.Tensor, bits: torch.Tensor,
                k_hashes: int = 7) -> torch.Tensor:
    """lo, hi: int32[N] (uint32 hash halves); bits: int32[W] packed filter,
    all on one CUDA device -> int32[N] hit mask."""
    dev = bits.device
    if dev.type != "cuda":
        raise ValueError("bloom_probe launches a CUDA kernel; "
                         f"got tensors on {dev}")
    n = lo.shape[0]
    _check("lo", lo, torch.int32, dev, n)
    _check("hi", hi, torch.int32, dev, n)
    _check("bits", bits, torch.int32, dev)
    w = bits.shape[0]
    if not 1 <= w < 2**27:
        raise ValueError(f"filter of {w} words: needs 1 <= words < 2**27")
    if not 0 <= k_hashes <= 64:
        raise ValueError(f"k_hashes={k_hashes} out of range")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bloom_probe(lo.data_ptr(), hi.data_ptr(), bits.data_ptr(),
                              w, n, k_hashes, out.data_ptr(), stream)
    _build.raise_on(err, "bloom_probe")
    launches["bloom_probe"] += 1
    return out


def bloom_probe_pairs(lo: torch.Tensor, hi: torch.Tensor,
                      word_off: torch.Tensor, num_words: torch.Tensor,
                      bits_concat: torch.Tensor,
                      k_hashes: int = 7) -> torch.Tensor:
    """Ragged pairs probe on the card.  lo, hi: int32[P]; word_off:
    int64[P] and num_words: int32[P] (each pair's filter inside
    ``bits_concat``, with 1 <= num_words < 2**27); bits_concat: int32[W]
    -> int32[P] hit mask."""
    dev = bits_concat.device
    if dev.type != "cuda":
        raise ValueError("bloom_probe_pairs launches a CUDA kernel; "
                         f"got tensors on {dev}")
    n = lo.shape[0]
    _check("lo", lo, torch.int32, dev, n)
    _check("hi", hi, torch.int32, dev, n)
    _check("word_off", word_off, torch.int64, dev, n)
    _check("num_words", num_words, torch.int32, dev, n)
    _check("bits_concat", bits_concat, torch.int32, dev)
    if not 0 <= k_hashes <= 64:
        raise ValueError(f"k_hashes={k_hashes} out of range")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bloom_probe_pairs(lo.data_ptr(), hi.data_ptr(),
                                    word_off.data_ptr(), num_words.data_ptr(),
                                    bits_concat.data_ptr(), n, k_hashes,
                                    out.data_ptr(), stream)
    _build.raise_on(err, "bloom_probe_pairs")
    launches["bloom_probe_pairs"] += 1
    return out
