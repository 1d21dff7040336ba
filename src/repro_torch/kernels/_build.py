"""Build a kernel source with nvcc and load it with ctypes.

Each source is compiled alone into a shared library with a plain C
interface, under ``build/repro_torch/`` in the checkout: no ninja and no
PyTorch headers are needed.  The library's name carries a hash of the
source, so an edited source is rebuilt and a built one is reused across
processes.  ``build_all`` starts one nvcc per source, all at once, and
waits for them together; ``start_all`` and ``finish_all`` do the two
apart, so that a caller can work while they compile.  ``refuse_grad`` is
the wrappers' guard against a launch whose output autograd could not
follow.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; "
                           "the CUDA kernels cannot be built")
    return str(path)


def library_path(source: Path) -> Path:
    """Where the library built from ``source`` (as it is now) lives."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def start_all(sources: Iterable[Path], force: bool = False) -> list:
    """Start one nvcc for every source that has no library yet (all of
    them when ``force``), all at once, and return without waiting: what
    ``finish_all`` (or ``stop_all``) takes."""
    started = []
    for src in map(Path, sources):
        lib = library_path(src)
        proc = cmd = tmp = log = None
        if force or not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            # the compiler's output to a file: a pipe nobody reads yet
            # could fill and stall it
            log = tempfile.TemporaryFile("w+")
            proc = subprocess.Popen(cmd, stdout=log,
                                    stderr=subprocess.STDOUT, text=True)
        started.append((lib, cmd, tmp, log, proc))
    return started


def finish_all(started: list) -> List[Path]:
    """Wait for ``start_all``'s compilers.  Returns the libraries' paths
    in the order of its sources; raises with the compiler's output if any
    build fails."""
    failed = []
    for lib, cmd, tmp, log, proc in started:
        if proc is None:
            continue
        proc.wait()
        log.seek(0)
        out = log.read()
        log.close()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [lib for lib, *_ in started]


def stop_all(started: list) -> None:
    """Kill what ``start_all`` started that still runs, and drop what it
    left half written."""
    for _, _, tmp, log, proc in started:
        if proc is not None:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
            tmp.unlink(missing_ok=True)


def build_all(sources: Iterable[Path], force: bool = False) -> List[Path]:
    """Compile every source that has no library yet (all of them when
    ``force``), one nvcc process each, started together.  Returns the
    libraries' paths in the order of ``sources``; raises with the
    compiler's output if any build fails."""
    return finish_all(start_all(sources, force))


def build(source: Path, force: bool = False) -> Path:
    """Compile one source (skipped when its library exists, unless
    ``force``).  Returns the library's path."""
    return build_all([source], force)[0]


_loaded: Dict[Path, ctypes.CDLL] = {}


def load(source: Path, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The library of ``source``, built if needed and loaded once per
    process (every launch calls this, so a loaded library is returned
    without touching the file system), with each C function's argument
    types declared (``signatures``); every launcher returns a
    ``cudaError_t`` as int."""
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[source] = lib
    return lib


def raise_on(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch)."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError {err}")


def refuse_grad(name: str, entry: str, *tensors: torch.Tensor) -> None:
    """Raise if grad mode is on and an input requires a gradient: a
    kernel's output written through a pointer carries no autograd graph,
    so the gradient would be lost without a word.  ``entry`` names the
    differentiable entry point to call instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward and its inputs require "
                           f"a gradient: call {entry}, whose autograd "
                           "Function launches it in the forward")
