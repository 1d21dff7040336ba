#!/usr/bin/env python3
"""Device time of the port's attention kernels at the main paths' shapes.

    python3 tools/attention_cost.py [--src DIR] [--reps N]

Seeded inputs at the shapes the main paths launch:

* ``flash_hymba``: Hymba-1.5B's prefill, bf16, B 4, 25 / 5 heads, S 2,048,
  D 64, causal, once with its 1,024-token window and once without;
* ``flash_qwen3``: the serving engine's Qwen3-1.7B prefill, fp32, B 1,
  16 / 8 heads, S 1,080, D 128, causal;
* ``paged_qwen3``: one Qwen3-1.7B decode step, fp32, B 1, 8 KV heads, G 2,
  D 128, a context of 1,180 positions in 74 pages of 16;
* ``flash_bwd_hymba`` and ``flash_bwd_qwen3``: flash's backward at the
  train paths' calls, bf16, causal: Hymba-1.5B's (as above, with its
  1,024-token window and without) and Qwen3-1.7B's in ``chip_smoke.py``'s
  phase 19a (B 2, 16 / 8 heads, S 256, D 128), dout in the layers'
  [B, S, H, D] memory.

Each kernel, through its wrapper, is checked against its plain version
(fp32 2e-5, bf16 2e-2) and timed two ways: the mean device time of one
launch from ``torch.profiler`` (the kernel alone), and CUDA events around
``--reps`` launches back to back (which is the host's launch path when
that is longer than the kernel).  Beside them: the bound (inputs read
once and the output written once over 3.35 TB/s, or 4 flops per query
head, visible key and head dim over the dtype's peak rate: 989 TFLOP/s
bf16 on the tensor cores, 67 fp32 on the CUDA cores), and
``scaled_dot_product_attention`` on the same inputs (a boolean mask for a
window; never used by the port), K/V repeated to every query head outside
the timed call, and for flash also with ``enable_gqa`` as ``chip_smoke.py``
calls it, where this PyTorch has it.  Where the flash wrapper takes its
tensor-core kernel, its CUDA-core kernel is timed on the same call too.
The backward rows are checked against ``attention_bwd_ref`` (2e-2 of each
gradient's largest) and a rerun bit for bit, and timed beside their bound
(10 flops a query head, visible key and head dim, as
``chip_smoke.py::flash_bwd_bound``) and the library's backward through
autograd (its graph kept between calls).

Prints the card's name and power limit, then one JSON line.  ``--src``
names the ``src`` directory to import ``repro_torch`` from (default: this
checkout's), so two versions of the port can be timed in one run.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12
RATE = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
BWD_TOL = 2e-2        # bf16 backward, of each gradient's largest
BWD_FLOPS = 10        # QK^T, dO V^T, P^T dO, dS^T Q, dS K


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                        attention_ref)
    from repro_torch.kernels.paged_attention import paged_attention as pk
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    if not torch.cuda.is_available():
        print("attention_cost: no CUDA card visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    fk.load()
    pk.load()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def randn(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    def events_ms(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.reps

    def kernels_ms(fn):
        """Mean device time a call of each operation ``fn`` launches, by
        name (the profiler's)."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        times = {ev.key: getattr(ev, "self_device_time_total",
                                 getattr(ev, "self_cuda_time_total", 0.0))
                 / 1e3 / args.reps for ev in prof.key_averages()}
        return {k: ms for k, ms in times.items() if ms > 0}

    def short(name):
        """A kernel's name without its namespaces and arguments."""
        found = re.search(r"(\w+_kernel)\b(<\w+>)?", name)
        return found.group(0) if found else name[:60]

    def device_ms(fn):
        """Mean device time of the kernels ``fn`` launches, per call."""
        total = sum(kernels_ms(fn).values())
        return total if total > 0 else None

    def timed(fn, want, tol):
        got = fn()
        err = float((got.float() - want.float()).abs().max())
        ok = bool(((got.float() - want.float()).abs()
                   <= tol + tol * want.float().abs()).all())
        return {"max_abs_err": err, "ok": ok, "device_ms": device_ms(fn),
                "events_ms": events_ms(fn)}

    def window_mask(s, window):
        pos = torch.arange(s, device=dev)
        return None if window is None else \
            (pos[None, :] <= pos[:, None]) & \
            (pos[None, :] > pos[:, None] - window)

    def backward_row(q, k, v, dout, window):
        """flash_attention_bwd on one causal call: checked against
        attention_bwd_ref (each gradient within BWD_TOL of its largest) and
        a rerun bit for bit, timed beside its bound and the backward of
        scaled_dot_product_attention (K/V repeated outside the timed
        call)."""
        b, h, s, d = q.shape
        out_, lse = fk.flash_attention_fwd(q, k, v, causal=True,
                                           window=window, with_lse=True)

        def bwd():
            return fk.flash_attention_bwd(q, k, v, out_, lse, dout,
                                          causal=True, window=window)
        got, again = bwd(), bwd()
        want = attention_bwd_ref(q, k, v, out_, dout, causal=True,
                                 window=window)
        rel = max(float((x.float() - y.float()).abs().max())
                  / float(y.float().abs().max()) for x, y in zip(got, want))
        row = {"max_rel_err": rel, "ok": rel <= BWD_TOL,
               "bitwise_repeat": all(torch.equal(x, y)
                                     for x, y in zip(got, again)),
               "variant": fk.bwd_variant(q.dtype, d),
               "kernels_ms": {short(k): ms for k, ms in kernels_ms(bwd).items()},
               "events_ms": events_ms(bwd)}
        row["device_ms"] = sum(row["kernels_ms"].values()) or None
        del got, again, want
        g = h // k.shape[1]
        mask = window_mask(s, window)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in
                      (q, k.repeat_interleave(g, 1),
                       v.repeat_interleave(g, 1))]
            lib_out = F.scaled_dot_product_attention(
                *leaves, attn_mask=mask, is_causal=mask is None)

        def lib():
            return torch.autograd.grad(lib_out, leaves, dout,
                                       retain_graph=True)
        row["library"] = {"device_ms": device_ms(lib),
                          "events_ms": events_ms(lib)}
        seen = float(np.minimum(np.arange(1, s + 1), window or s).sum())
        flops = BWD_FLOPS * b * h * d * seen
        nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
            + 4 * lse.numel()
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / RATE["bfloat16"]
        ms = row["device_ms"] or row["events_ms"]
        row.update({"bound_ms": 1e3 * max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "tflops": flops / ms / 1e9,
                    "dtype": "bfloat16", "shape": [b, h, k.shape[1], s, d],
                    "window": window})
        row["share"] = row["bound_ms"] / ms
        return row

    try:     # enable_gqa, as chip_smoke.py's phases 8 and 12 call it
        x = torch.zeros(1, 2, 1, 8, device=dev)
        F.scaled_dot_product_attention(x, x[:, :1], x[:, :1],
                                       enable_gqa=True)
        gqa = True
    except TypeError:
        gqa = False
    out = {"src": str(Path(args.src)), "card": card}
    variant = getattr(fk, "variant", None)
    for name, dtype, (b, h, kvh, s, d), windows in (
            ("flash_hymba", torch.bfloat16, (4, 25, 5, 2048, 64),
             (1024, None)),
            ("flash_qwen3", torch.float32, (1, 16, 8, 1080, 128), (None,))):
        dname = str(dtype).split(".")[1]
        q = randn((b, h, s, d), dtype)
        k, v = randn((b, kvh, s, d), dtype), randn((b, kvh, s, d), dtype)
        for window in windows:
            want = attention_ref(q, k, v, causal=True, window=window)
            row = timed(lambda: fk.flash_attention_fwd(
                q, k, v, causal=True, window=window), want, TOL[dname])
            if variant is not None:
                row["variant"] = variant(dtype, d)
                if row["variant"] != "simt":
                    def simt():
                        o = torch.empty_like(q)
                        fk.launch("simt", q, k, v, o, True, window)
                        return o
                    row["simt"] = timed(simt, want, TOL[dname])
            mask = window_mask(s, window)
            g = h // kvh
            kr, vr = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
            row["library"] = timed(lambda: F.scaled_dot_product_attention(
                q, kr, vr, attn_mask=mask, is_causal=mask is None), want,
                TOL[dname])
            if gqa:
                row["library_gqa"] = timed(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, is_causal=mask is None,
                        enable_gqa=True), want, TOL[dname])
            seen = float(np.minimum(np.arange(1, s + 1), window or s).sum())
            nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
            row["bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                        4 * b * h * d * seen / RATE[dname])
            row["tflops"] = 4 * b * h * d * seen / (row["device_ms"] or
                                                    row["events_ms"]) / 1e9
            row["dtype"], row["shape"] = dname, [b, h, kvh, s, d]
            out[f"{name}_window{window}"] = row
            del want

    # flash's backward at the train paths' shapes, bf16, causal
    for name, (b, h, kvh, s, d), windows in (
            ("flash_bwd_hymba", (4, 25, 5, 2048, 64), (None, 1024)),
            ("flash_bwd_qwen3", (2, 16, 8, 256, 128), (None,))):
        q = randn((b, h, s, d), torch.bfloat16)
        k = randn((b, kvh, s, d), torch.bfloat16)
        v = randn((b, kvh, s, d), torch.bfloat16)
        dout = randn((b, s, h, d), torch.bfloat16).transpose(1, 2)
        for window in windows:
            out[f"{name}_window{window}"] = backward_row(
                q, k, v, dout, window)

    # paged: one decode step of Qwen3-1.7B over a compact block table
    kvh, g, d, ps, ctx = 8, 2, 128, 16, 1180
    n_pages = -(-ctx // ps)
    q = randn((1, kvh * g, d), torch.float32)
    kp = randn((n_pages, ps, kvh, d), torch.float32)
    vp = randn((n_pages, ps, kvh, d), torch.float32)
    tables = torch.arange(n_pages, dtype=torch.int32, device=dev)[None]
    lens = torch.tensor([ctx - 1], dtype=torch.int32, device=dev)
    want = paged_attention_ref(q, kp, vp, tables, lens)
    row = timed(lambda: pk.paged_attention_decode(q, kp, vp, tables, lens),
                want, TOL["float32"])
    if hasattr(pk, "split_plan"):
        row["splits"] = list(pk.split_plan(n_pages, ps))
    kk, vv = (p.reshape(-1, kvh, d)[:ctx].transpose(0, 1)[None]
              .repeat_interleave(g, 1).contiguous() for p in (kp, vp))
    row["library"] = timed(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kk, vv)[:, :, 0], want, TOL["float32"])
    row["plain"] = timed(lambda: paged_attention_ref(q, kp, vp, tables,
                                                     lens), want,
                         TOL["float32"])
    row["bound_ms"] = 1e3 * (2 * ctx * kvh * d + 2 * q.numel()) * 4 \
        / HBM_BYTES_PER_S
    row["shape"] = {"kv": kvh, "g": g, "d": d, "page_size": ps,
                    "context": ctx}
    out["paged_qwen3"] = row
    print(json.dumps(out), flush=True)
    bad = [n for n, r in out.items() if isinstance(r, dict) and (
        r.get("bitwise_repeat") is False or
        not all(x.get("ok", True) for x in [r] + [
            v for v in r.values() if isinstance(v, dict)]))]
    if bad:
        print(f"attention_cost: outside tolerance or not bit for bit on a "
              f"rerun: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
