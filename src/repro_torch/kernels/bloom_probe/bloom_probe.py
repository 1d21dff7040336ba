"""Build and launch the CUDA Bloom-probe kernels (``csrc/bloom_probe.cu``).

The source is compiled at first use with nvcc into a shared library and
bound with ctypes (``kernels/_build.py``).

Two levels of entry:

* ``launch_single`` / ``launch_pairs``, the read path's: they take an
  :class:`Image` (the resident filter image and slot table, checked once
  when it is made) and device addresses of per-call operands that the
  caller laid out itself, check sizes only, and launch on the current
  stream without synchronising.  Each adds one to ``launches`` where it
  launches its kernel.
* ``bloom_probe`` / ``bloom_probe_pairs``: the same kernels on tensors,
  every tensor checked (device, dtype, contiguity, sizes, the pairs'
  indices in range), the output allocated.  They launch through the two
  above.

Both raise on a CPU tensor or a refused launch; nothing falls back.
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
    "bloom_probe_pairs": [_VP] * 7 + [_LL, _VP, _VP],
}
MAX_WORDS = 2**27         # a filter's words: num_words * 32 must fit uint32
MAX_K = 64

launches: Dict[str, int] = {"bloom_probe": 0, "bloom_probe_pairs": 0}
_fns: Dict[str, object] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def load() -> ctypes.CDLL:
    """Build if needed, then load the library, declare its signatures and
    keep its two C functions for the launchers."""
    lib = _build.load(SOURCE, SIGNATURES)
    if not _fns:
        _fns.update({name: getattr(lib, name) for name in SIGNATURES})
    return lib


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


class Image:
    """A resident filter image (``words`` int32[W], uint32 bits) and its
    slot table (``slot_off`` int64[S], ``slot_words`` int32[S]: each
    filter's first word and word count), on one CUDA device.  Every check
    of the resident tensors happens here, once: device, dtype, contiguity,
    and each slot inside the image with 1 <= words < 2**27 (one device
    reduction)."""

    __slots__ = ("words", "slot_off", "slot_words", "device", "index",
                 "n_words", "n_slots", "ptrs", "words_addr")

    def __init__(self, words: torch.Tensor,
                 slot_off: Optional[torch.Tensor] = None,
                 slot_words: Optional[torch.Tensor] = None):
        dev = words.device
        if dev.type != "cuda":
            raise ValueError("the Bloom-probe kernels take a filter image on "
                             f"a CUDA device; got one on {dev}")
        if slot_off is None:
            slot_off = torch.zeros(1, dtype=torch.int64, device=dev)
            slot_words = torch.full((1,), words.shape[0], dtype=torch.int32,
                                    device=dev)
        _check("words", words, torch.int32, dev)
        _check("slot_off", slot_off, torch.int64, dev)
        _check("slot_words", slot_words, torch.int32, dev, slot_off.shape[0])
        n_words = words.shape[0]
        if slot_off.shape[0] and bool(
                ((slot_words < 1) | (slot_words >= MAX_WORDS) | (slot_off < 0)
                 | (slot_off + slot_words > n_words)).any()):
            raise ValueError("a slot lies outside the image or has a filter "
                             f"of words outside [1, {MAX_WORDS})")
        self.words, self.slot_off = words, slot_off
        self.slot_words = slot_words
        self.device, self.index = dev, dev.index
        self.n_words, self.n_slots = n_words, slot_off.shape[0]
        # the launchers' constant arguments, converted for ctypes once
        self.ptrs = tuple(ctypes.c_void_p(t.data_ptr())
                          for t in (slot_off, slot_words, words))
        self.words_addr = words.data_ptr()


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(index: int) -> int:
    """The current stream's handle on device ``index`` (without making a
    ``torch.cuda.Stream`` where PyTorch offers the raw handle)."""
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch_single(image: Image, word_off: int, num_words: int, n: int,
                  lo: int, hi: int, k: int, out: int) -> None:
    """``bloom_probe`` on the filter of ``num_words`` words at
    ``word_off`` inside ``image``: ``lo``, ``hi`` and ``out`` are device
    addresses of uint32[n], uint32[n] and int32[n] on the image's device."""
    if not (0 <= word_off and 1 <= num_words < MAX_WORDS
            and word_off + num_words <= image.n_words):
        raise ValueError(f"filter of {num_words} words at {word_off} is not "
                         f"inside an image of {image.n_words}")
    if not 0 <= k <= MAX_K or n < 0:
        raise ValueError(f"k={k}, n={n} out of range")
    if n == 0:
        return
    if not _fns:
        load()
    idx = image.index
    if torch.cuda.current_device() != idx:
        with torch.cuda.device(idx):
            return launch_single(image, word_off, num_words, n, lo, hi, k,
                                 out)
    err = _fns["bloom_probe"](lo, hi, image.words_addr + 4 * word_off,
                              num_words, n, k, out, _stream(idx))
    _build.raise_on(err, "bloom_probe")
    launches["bloom_probe"] += 1


def launch_pairs(image: Image, n_keys: int, n_pairs: int, keys: int,
                 pair_key: int, pair_slot: int, pair_k: int,
                 out: int) -> None:
    """``bloom_probe_pairs`` against ``image``: ``keys`` (uint64[n_keys]),
    ``pair_key`` and ``pair_slot`` (int32[n_pairs], each key's index and
    each pair's slot, in range), ``pair_k`` (uint8[n_pairs]) and ``out``
    (uint8[n_pairs]) are device addresses on the image's device."""
    if n_keys < 0 or n_pairs < 0 or (n_pairs and not n_keys) or \
            (n_pairs and not image.n_slots):
        raise ValueError(f"{n_pairs} pairs over {n_keys} keys and "
                         f"{image.n_slots} slots")
    if n_pairs == 0:
        return
    if not _fns:
        load()
    idx = image.index
    if torch.cuda.current_device() != idx:
        with torch.cuda.device(idx):
            return launch_pairs(image, n_keys, n_pairs, keys, pair_key,
                                pair_slot, pair_k, out)
    slot_off, slot_words, words = image.ptrs
    err = _fns["bloom_probe_pairs"](keys, pair_key, pair_slot, pair_k,
                                    slot_off, slot_words, words, n_pairs, out,
                                    _stream(idx))
    _build.raise_on(err, "bloom_probe_pairs")
    launches["bloom_probe_pairs"] += 1


def bloom_probe(lo: torch.Tensor, hi: torch.Tensor, bits: torch.Tensor,
                k_hashes: int = 7) -> torch.Tensor:
    """lo, hi: int32[N] (uint32 hash halves); bits: int32[W] packed filter,
    all on one CUDA device -> int32[N] hit mask."""
    image = Image(bits)
    n = lo.shape[0]
    _check("lo", lo, torch.int32, image.device, n)
    _check("hi", hi, torch.int32, image.device, n)
    out = torch.empty(n, dtype=torch.int32, device=image.device)
    launch_single(image, 0, image.n_words, n, lo.data_ptr(), hi.data_ptr(),
                  k_hashes, out.data_ptr())
    return out


def bloom_probe_pairs(keys: torch.Tensor, pair_key: torch.Tensor,
                      pair_slot: torch.Tensor, pair_k: torch.Tensor,
                      slot_off: torch.Tensor, slot_words: torch.Tensor,
                      words: torch.Tensor) -> torch.Tensor:
    """Pairs probe on the card.  keys: int64[n] (the uint64 keys' bits);
    pair_key, pair_slot: int32[P] (each in range); pair_k:
    uint8[P]; slot_off: int64[S], slot_words: int32[S]; words: int32[W]
    -> uint8[P] hit mask."""
    image = Image(words, slot_off, slot_words)
    n, p = keys.shape[0], pair_key.shape[0]
    _check("keys", keys, torch.int64, image.device, n)
    _check("pair_key", pair_key, torch.int32, image.device, p)
    _check("pair_slot", pair_slot, torch.int32, image.device, p)
    _check("pair_k", pair_k, torch.uint8, image.device, p)
    if p and bool(((pair_key < 0) | (pair_key >= n) | (pair_slot < 0)
                   | (pair_slot >= image.n_slots)).any()):
        raise ValueError("a pair names a key or a slot out of range")
    out = torch.empty(p, dtype=torch.uint8, device=image.device)
    launch_pairs(image, n, p, keys.data_ptr(), pair_key.data_ptr(),
                 pair_slot.data_ptr(), pair_k.data_ptr(), out.data_ptr())
    return out
