#!/usr/bin/env python3
"""Device time of the port's selective scan kernels at the model prefills'
shapes.

    python3 tools/scan_cost.py [--src DIR] [--reps N] [--seed S] [--probe]
                               [--v1-options CHxST,...] [--parts P,...]
                               [--bwd-channels CH,...]

Seeded inputs (dt > 0, A < 0, fp32, as a Mamba layer feeds the scan) at
the two shapes a model prefill launches, one fused scan a Mamba layer:

* ``falcon``: Falcon-Mamba-7B's prefill, B 4, T 2,048, di 8,192, N 16;
* ``hymba``: Hymba-1.5B's prefill, B 4, T 2,048, di 3,200, N 16.

At each, the fused kernel (through its wrapper, with the launch shape the
wrapper picks) and v1 (bx = (dt * x) * B formed outside, not timed) are
checked against their plain versions within 1e-4 + 1e-4 * |y| and timed
with CUDA events recorded just before and just after one launch, the
same launch queued first so that the events bracket the kernel alone (as
``chip_smoke.py``'s ``bracketed_ms``).  Where the checkout's fused
wrapper has ``plan`` and ``shape``, every lanes-a-channel option it is
built for is checked and timed too.  Where v1's wrapper has them, its
plan is printed beside its time (channels a block, stages, the busiest
SM's channels over the mean), and v1 is checked and timed at other
launch options (``v1_by_option``, "channels x stages": the plan's
channels at 1 stage up to the plan's, and 32, 64, 128 and 256 channels
a block at the stages ``plan`` would give them) and on its scalar route
(``v1_scalar``: bx offset by one float, so not 16-byte aligned).
``--v1-options`` names the options to time instead, "channels x stages"
each; an option the launch refuses (a ring past a block's shared memory)
is reported as refused.

The fused scan's backward (``bwd``; dy seeded too) is checked against
``selective_scan_fused_bwd_ref``, each of its five gradients within 1e-4
of that gradient's largest, then timed the same way through its wrapper
(its kernels); beside it ``peak_bytes``, what one call allocates at its
peak (its gradients and scratch), from ``torch.cuda.max_memory_allocated``.
Where the checkout's fused module has ``bwd_plan`` and ``bwd_shape``,
its plan is printed beside it (channels a block, grid) and it is checked
and timed at other channels a block too (``bwd_by_channels``: 32, 64,
104, 128 and the plan's, or ``--bwd-channels`` and the plan's); where it
has ``bwd_occupancy``, each of those
carries what the card reports for the compiled kernel (shared memory a
block, blocks an SM, registers and spilled bytes a thread) and the
waves its grid makes at those blocks an SM.

Beside each time: the byte bound (inputs read once, outputs written
once, over 3.35 TB/s; the backward's as ``chip_smoke.py``'s
``scan_bwd_bound``: dt, x, dy, B, C, A read, their gradients written)
and the special-function-unit term: one exponential a (t, d, n) for the
forwards, BWD_EXPONENTIALS = 2 for the backward (its pass 1 and its
recompute; the walk back reuses the recompute's decays), each B * T * di
* N over SMs x 16 a clock x the SM's maximum clock (SMs from
``torch.cuda.get_device_properties``, the clock from ``nvidia-smi
--query-gpu=clocks.max.sm``).  ``--parts`` names what to time, of
``fused``, ``v1`` and ``bwd`` (default all).

Prints the card's name and power limit, then one JSON line.  ``--src``
names the ``src`` directory to import ``repro_torch`` from (default: this
checkout's), so two versions of the kernel can be timed in one run.

``--probe`` measures, instead, what bounds the fused kernel, with a probe
source built here by nvcc into ``build/scan_probe/``:

* ``sfu``: ``ex2.approx`` alone (8 independent chains a thread) and the
  fused kernel's arithmetic alone (its FMA, ``ex2.approx``, multiply and
  two FMAs a (t, d, n) on 8 states a thread, no memory), in
  exponentials a clock an SM at 4 to 32 warps an SM;
* ``decay``: the error of the decay exp(dt * A) in ulps of the result
  against float64, on 2^22 arguments dt * A from -1e-7 to -10 (log
  spaced): ``ex2.approx(dt * A log2 e)``, the kernel's
  ``0.5 * ex2.approx(dt * A log2 e + 1)``, ``expf`` and ``torch.exp`` (the
  plain version's), over all arguments and over |dt * A| < 1e-3.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12
SFU_PER_CLOCK = 16          # exponentials an SM returns a clock (cc 9.0)
TOL = 1e-4
BWD_EXPONENTIALS = 2        # the backward's exponentials a (t, d, n)
BWD_CHANNELS = (32, 64, 104, 128)
SHAPES = {"falcon": (4, 2048, 8192, 16), "hymba": (4, 2048, 3200, 16)}


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


PROBE_SOURCE = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__global__ void sfu_only(float* out, int iters) {
  float v[8];
  for (int j = 0; j < 8; ++j) v[j] = -0.001f * (threadIdx.x + j);
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = -ex2(v[j]);
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += v[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void step_mix(float* out, int iters) {
  float u[8], a2[8], b[8], c[8];
  for (int j = 0; j < 8; ++j) {
    u[j] = 0.f; a2[j] = -0.01f * (j + 1); b[j] = 0.1f * j; c[j] = 0.2f * j;
  }
  float dt = 0.01f * threadIdx.x, x = 0.5f, acc = 0.f;
  for (int i = 0; i < iters; ++i) {
    const float dtx = dt * x;
    float p0 = 0.f, p1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      u[j] = fmaf(u[j], ex2(fmaf(dt, a2[j], 1.f)), dtx * b[j]);
      p0 = fmaf(u[j], c[j], p0);
    }
#pragma unroll
    for (int j = 4; j < 8; ++j) {
      u[j] = fmaf(u[j], ex2(fmaf(dt, a2[j], 1.f)), dtx * b[j]);
      p1 = fmaf(u[j], c[j], p1);
    }
    acc += p0 + p1;
    dt = fmaf(dt, 0.999f, 0.0001f);
    x = -x;
#pragma unroll
    for (int j = 0; j < 8; ++j) u[j] *= 0.5f;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
__global__ void decays(const float* dt, const float* a, float* unshifted,
                       float* shifted, float* accurate, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const float a2 = a[i] * 1.4426950408889634f;
    unshifted[i] = ex2(dt[i] * a2);
    shifted[i] = 0.5f * ex2(fmaf(dt[i], a2, 1.f));
    accurate[i] = expf(dt[i] * a[i]);
  }
}
extern "C" int throughput(int which, void* out, int blocks, int threads,
                          int iters) {
  if (which == 0)
    sfu_only<<<blocks, threads>>>(static_cast<float*>(out), iters);
  else
    step_mix<<<blocks, threads>>>(static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int decay(const void* dt, const void* a, void* o1, void* o2,
                     void* o3, int n) {
  decays<<<(n + 255) / 256, 256>>>(
      static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<float*>(o1), static_cast<float*>(o2),
      static_cast<float*>(o3), n);
  return static_cast<int>(cudaGetLastError());
}
"""


def probe(torch, sms: int, max_mhz: float) -> dict:
    """What bounds the fused kernel: the ``sfu`` and ``decay`` probes of
    the module's docstring."""
    import ctypes

    from repro_torch.kernels import _build

    src = ROOT / "build" / "scan_probe" / "scan_probe.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(PROBE_SOURCE)
    lib_path = src.with_suffix(".so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                    str(lib_path), str(src)], check=True, timeout=300)
    lib = ctypes.CDLL(str(lib_path))
    lib.throughput.argtypes = [ctypes.c_int, ctypes.c_void_p] + \
        [ctypes.c_int] * 3
    lib.decay.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int]
    dev = torch.device("cuda")
    out = {"sfu": {}}
    buf = torch.empty(sms * 32 * 32, device=dev)
    iters, threads = 4096, 128
    for which, name in ((0, "ex2_only"), (1, "scan_arithmetic")):
        row = {}
        for warps in (4, 8, 16, 32):
            blocks = sms * warps // 4
            assert lib.throughput(which, buf.data_ptr(), blocks, threads,
                                  iters) == 0
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            lib.throughput(which, buf.data_ptr(), blocks, threads, iters)
            end.record()
            end.synchronize()
            sec = start.elapsed_time(end) / 1e3
            row[f"{warps}_warps_per_sm"] = (blocks * threads * iters * 8
                                            / sec / (sms * max_mhz * 1e6))
        out["sfu"][name] = row
    n = 1 << 22
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    dt = torch.rand(n, generator=gen, device=dev) * 0.2 + 0.01
    x = -torch.logspace(-7, 1, n, device=dev)
    a = x / dt
    o1, o2, o3 = (torch.empty_like(dt) for _ in range(3))
    assert lib.decay(dt.data_ptr(), a.data_ptr(), o1.data_ptr(),
                     o2.data_ptr(), o3.data_ptr(), n) == 0
    exact = torch.exp(dt.double() * a.double())
    near1 = (dt * a).abs() < 1e-3
    out["decay"] = {}
    for name, got in (("ex2_unshifted", o1), ("ex2_shifted", o2),
                      ("expf", o3), ("torch_exp", torch.exp(dt * a))):
        ulp = (torch.nextafter(got, torch.full_like(got, 2.0)) - got).double()
        err = (got.double() - exact) / ulp
        out["decay"][name] = {
            "mean_ulp": float(err.mean()), "max_ulp": float(err.abs().max()),
            "near_1_mean_ulp": float(err[near1].mean()),
            "near_1_max_ulp": float(err[near1].abs().max()),
            "same_as_torch_exp": float((got == torch.exp(dt * a))
                                       .double().mean())}
    return out


def v1_options(sk, b: int, di: int, sms: int) -> list:
    """(channels, stages) of v1's launch to time beside its plan: the
    plan's channels at 1 stage up to the plan's, then 32, 64, 128 and 256
    channels a block at the stages ``plan`` would give them."""
    p = sk.plan(b, di, sms)
    out = [(p.channels, st) for st in range(1, p.stages + 1)]
    for ch in (32, 64, 128, 256):
        st = sk.plan_stages(b, di, ch, sms)
        if st >= 1 and (ch, st) not in out:
            out.append((ch, st))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--probe", action="store_true",
                    help="measure what bounds the fused kernel instead")
    ap.add_argument("--v1-options", default=None,
                    help="v1's launch options to time, e.g. 256x2,128x4")
    ap.add_argument("--parts", default="fused,v1,bwd",
                    help="what to time, of fused, v1 and bwd")
    ap.add_argument("--bwd-channels", default=None,
                    help="the backward's channels a block to time beside "
                    "its plan's, e.g. 64,128 (empty: the plan's alone)")
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    bwd_channels = (BWD_CHANNELS if args.bwd_channels is None else
                    [int(c) for c in args.bwd_channels.split(",") if c])
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch

    from repro_torch.kernels.selective_scan import fused as fk
    from repro_torch.kernels.selective_scan import selective_scan as sk
    from repro_torch.kernels.selective_scan.ref import (
        selective_scan_fused_bwd_ref, selective_scan_fused_ref,
        selective_scan_ref)

    if not torch.cuda.is_available():
        print("scan_cost: no CUDA card visible", file=sys.stderr)
        return 2
    card = smi("name,power.limit")
    print(card, flush=True)
    max_mhz = float(smi("clocks.max.sm").split()[0])
    sk.load()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev)

    def bracketed_ms(fn, call):
        pairs = []
        for _ in range(args.reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            fn(*call)
            start.record()
            fn(*call)
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / len(pairs)

    def v1_forced(b, di, channels, stages):
        p = sk.shape(b, di, channels, stages)

        def fn(dt, bx, c, a):
            y = torch.empty_like(dt)
            sk.launch(p, dt, bx, c, a, y)
            return y
        return fn

    def checked(fn, call, want):
        got = fn(*call)
        err = (got - want).abs()
        return {"max_abs_err": float(err.max()),
                "ok": bool((err <= TOL + TOL * want.abs()).all()),
                "ms": bracketed_ms(fn, call)}

    def fused_rows(b, di, call):
        want = selective_scan_fused_ref(*call)
        row = {"fused": checked(fk.selective_scan_fused, call, want)}
        if hasattr(fk, "plan") and hasattr(fk, "shape"):
            row["fused"]["lanes"] = fk.plan(b, di, sms).lanes

            def forced(lanes):
                def fn(*cl):
                    y = torch.empty_like(cl[0])
                    fk.launch(fk.shape(b, di, lanes), *cl, y)
                    return y
                return fn
            row["fused_by_lanes"] = {
                str(lanes): checked(forced(lanes), call, want)
                for lanes in fk.LANES}
        return row

    def v1_rows(b, di, call):
        dt, x, bm, c, a = call
        bx = (dt * x)[..., None] * bm[:, :, None, :]
        v1_call = (dt, bx, c, a)
        v1_want = selective_scan_ref(*v1_call)
        row = {"v1": checked(sk.selective_scan, v1_call, v1_want)}
        if hasattr(sk, "plan") and hasattr(sk, "shape"):
            p = sk.plan(b, di, sms)
            row["v1"]["plan"] = {
                "channels": p.channels, "stages": p.stages,
                "threads": p.threads, "grid": list(p.grid),
                "busiest_sm_over_mean": sk.busiest_sm(
                    b, di, p.channels, sms) / (b * di / sms)}
            options = (v1_options(sk, b, di, sms) if args.v1_options is None
                       else [tuple(map(int, o.split("x")))
                             for o in args.v1_options.split(",")])
            row["v1_by_option"] = {}
            for ch, st in options:
                try:
                    fn = v1_forced(b, di, ch, st)
                except ValueError as err:
                    row["v1_by_option"][f"{ch}x{st}"] = {"refused": str(err)}
                    continue
                row["v1_by_option"][f"{ch}x{st}"] = checked(fn, v1_call,
                                                            v1_want)
            shifted = torch.empty(bx.numel() + 1, device=dev)
            shifted = shifted[1:].view(bx.shape)
            shifted.copy_(bx)
            del bx
            row["v1_scalar"] = checked(sk.selective_scan,
                                       (dt, shifted, c, a), v1_want)
            del shifted
        return row

    def bwd_checked(fn, call, want):
        got = fn(*call)
        errs = {name: float((g - w).abs().max()) / float(w.abs().max())
                for name, g, w in zip(("ddt", "dx", "dB", "dC", "dA"), got,
                                      want)}
        again = fn(*call)
        same = all(torch.equal(g, h) for g, h in zip(got, again))
        del got, again
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(*call)
        torch.cuda.synchronize()
        return {"rel_err": errs,
                "ok": all(e <= TOL for e in errs.values()),
                "bitwise_repeat": same,
                "peak_bytes": torch.cuda.max_memory_allocated() - before,
                "ms": bracketed_ms(fn, call)}

    def bwd_occupancy(p):
        if not hasattr(fk, "bwd_occupancy"):
            return {}
        occ = fk.bwd_occupancy(p.channels, dev)
        return {**occ._asdict(), "waves": p.grid[0] * p.grid[1]
                / (sms * occ.blocks_per_sm)}

    def bwd_rows(b, di, call, dy):
        bcall = (*call, dy)
        want = selective_scan_fused_bwd_ref(*bcall)
        row = {"bwd": bwd_checked(fk.selective_scan_fused_bwd, bcall, want)}
        if hasattr(fk, "bwd_plan") and hasattr(fk, "bwd_shape"):
            p = fk.bwd_plan(b, di, sms)
            row["bwd"]["plan"] = {
                "channels": p.channels, "threads": p.threads,
                "grid": list(p.grid), **bwd_occupancy(p)}
            row["bwd_by_channels"] = {}
            for ch in sorted({*bwd_channels, p.channels}):
                q = fk.bwd_shape(b, di, ch, sms)
                row["bwd_by_channels"][str(ch)] = {
                    **bwd_checked(lambda *cl: fk.bwd_launch(q, *cl), bcall,
                                  want),
                    **bwd_occupancy(q)}
        del want
        return row

    out = {"src": str(Path(args.src)), "card": card, "sms": sms,
           "max_sm_mhz": max_mhz}
    if args.probe:
        print(json.dumps({**out, **probe(torch, sms, max_mhz)}), flush=True)
        return 0
    for name, (b, t, di, n) in SHAPES.items():
        gen.manual_seed(args.seed)
        dt = torch.rand((b, t, di), generator=gen, device=dev) * 0.2
        x = torch.randn((b, t, di), generator=gen, device=dev)
        bm = torch.randn((b, t, n), generator=gen, device=dev) * 0.3
        c = torch.randn((b, t, n), generator=gen, device=dev)
        a = -torch.rand((di, n), generator=gen, device=dev) * 2 - 0.05
        call = (dt, x, bm, c, a)
        row = {"shape": [b, t, di, n]}
        if "fused" in parts:
            row.update(fused_rows(b, di, call))
        if "v1" in parts:
            row.update(v1_rows(b, di, call))
        if "bwd" in parts:
            dy = torch.randn((b, t, di), generator=gen, device=dev)
            row.update(bwd_rows(b, di, call, dy))
            del dy
        bytes_fused = 4 * (3 * b * t * di + 2 * b * t * n + di * n)
        bytes_v1 = 4 * (2 * b * t * di + b * t * di * n + b * t * n
                        + di * n)
        bytes_bwd = 4 * (5 * b * t * di + 4 * b * t * n + 2 * di * n)
        row["bound_ms"] = 1e3 * bytes_fused / HBM_BYTES_PER_S
        row["v1_bound_ms"] = 1e3 * bytes_v1 / HBM_BYTES_PER_S
        row["bwd_bound_ms"] = 1e3 * bytes_bwd / HBM_BYTES_PER_S
        row["bound_sfu_ms"] = 1e3 * b * t * di * n / (
            sms * SFU_PER_CLOCK * max_mhz * 1e6)
        row["bwd_bound_sfu_ms"] = BWD_EXPONENTIALS * row["bound_sfu_ms"]
        if "fused" in row:
            row["fused"]["share_of_bound"] = (row["bound_ms"]
                                              / row["fused"]["ms"])
        if "bwd" in row:
            row["bwd"]["share_of_bound"] = (row["bwd_bound_ms"]
                                            / row["bwd"]["ms"])
        out[name] = row
        del call, dt, x, bm, c, a
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)

    def bad(r):
        return isinstance(r, dict) and (
            r.get("ok") is False or r.get("bitwise_repeat") is False
            or any(bad(v) for v in r.values()))
    if bad(out):
        print("scan_cost: a kernel outside tolerance", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
