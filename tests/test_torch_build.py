"""The kernel build's start / finish split (``kernels/_build.py``) with a
stand-in compiler, so it runs without nvcc: what ``chip_smoke.py`` uses to
compile kernels while its first phases run."""
from __future__ import annotations

import os
import time

import pytest

from repro_torch.kernels import _build

# writes the file after -o once it has slept $NVCC_SLEEP seconds, or
# fails with exit 3 and a message when $NVCC_FAIL is set
FAKE_NVCC = """#!/bin/sh
sleep "${NVCC_SLEEP:-0}"
if [ -n "$NVCC_FAIL" ]; then echo "error in $NVCC_FAIL"; exit 3; fi
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then echo built > "$a"; fi
  prev="$a"
done
"""


@pytest.fixture
def fake(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    sources = []
    for name in ("a", "b"):
        src = tmp_path / f"{name}.cu"
        src.write_text(f"// {name}\n")
        sources.append(src)
    return sources


def test_start_then_finish_builds_in_order(fake, monkeypatch):
    """The compilers run while the caller works; ``finish_all`` returns
    every library, in the sources' order, built; a source whose library
    exists starts no compiler unless forced."""
    monkeypatch.setenv("NVCC_SLEEP", "0.5")
    t0 = time.perf_counter()
    started = _build.start_all(fake)
    assert time.perf_counter() - t0 < 0.4
    libs = _build.finish_all(started)
    assert libs == [_build.library_path(s) for s in fake]
    assert all(lib.read_text() == "built\n" for lib in libs)
    again = _build.start_all(fake)
    assert [proc for *_, proc in again] == [None, None]
    assert _build.finish_all(again) == libs
    assert all(proc is not None for *_, proc in
               _build.start_all(fake, force=True))


def test_finish_raises_with_the_compiler_output(fake, monkeypatch):
    monkeypatch.setenv("NVCC_FAIL", "kernel.cu")
    started = _build.start_all(fake)
    with pytest.raises(RuntimeError, match="error in kernel.cu"):
        _build.finish_all(started)
    assert not any(_build.library_path(s).exists() for s in fake)


def test_stop_kills_the_compilers(fake, monkeypatch):
    monkeypatch.setenv("NVCC_SLEEP", "30")
    started = _build.start_all(fake)
    _build.stop_all(started)
    assert all(proc.returncode is not None for *_, proc in started)
    assert not any(_build.library_path(s).exists() for s in fake)
    assert os.listdir(_build.BUILD_DIR) == []
