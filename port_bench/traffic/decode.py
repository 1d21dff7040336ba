"""Batched decode driver: a closed loop of the port's serve step
(``models/steps.py::make_serve_step``) over ``batch`` sequences at once.
Each sequence gets a ``prompt``-token prompt drawn from the seed, forced
through the serve step during set-up (the warm-up: the one shape the
window uses), and then decodes greedily; none finishes inside the
window.  Each step ends when its tokens reach the host, as a server
streams them.

End-to-end: ``decode_tokens_per_s``, every token generated over the
window.  ``token_gap_ms_p95``, the 95th percentile of the gaps between a
sequence's consecutive tokens (every sequence gets its token at the
same step, so one gap a step; the first from the window's start), over
the steps no profiler stretch covered, goes to ``run.traced``: a
per-layer metric, as a closed loop at full batch is paced by its
throughput and its tail swings from run to run.

The check samples ``check_rows`` sequences from the seed, keeps their
tokens and the state the program's caches hold at the end, frees the
program, and runs the reference's full forward pass over each sample's
prompt and served tokens:
- ``token_gap``: the widest gap by which a served token's reference
  logit lies below the reference's best at that position;
- ``ssm_gap``, ``conv_gap``: the worst layer's and sample's relative
  distance (Frobenius) of the program's SSM state and convolution inputs
  from the reference's after the same tokens.

Planted faults: ``unchanged`` (the caches are never written),
``half_batch`` (the step serves the first half of the sequences; the
rest get copies of their tokens), ``token_altered`` (the window's second
step hands every sequence its neighbour's token).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from port_bench import data, weights as W
from port_bench.counts import model as counts
from port_bench.reference import model as reference
from port_bench.traffic.common import Patches, exact_fp32, sample


def _serve(run, st, tok: torch.Tensor, step: int = -1) -> torch.Tensor:
    if "half_batch" in run.faults:
        h = tok.shape[0] // 2
        part = {k: v[:, :h] for k, v in st.caches.items()}
        nt, _, _ = st.serve(st.model, tok[:h], st.cache_len[:h], part)
        nt = torch.cat([nt, nt[: tok.shape[0] - h]])
    else:
        nt, _, st.caches = st.serve(st.model, tok, st.cache_len, st.caches)
    st.cache_len += 1
    if "token_altered" in run.faults and step == 1:
        nt = torch.roll(nt, 1, dims=0)
    return nt


def setup(run):
    from repro_torch.models import model as M
    from repro_torch.models import steps
    cfg, mix = run.cfg, run.mix
    pcfg = run.program_config()
    b, p = mix["batch"], mix["prompt"]
    st = SimpleNamespace(patches=Patches())
    st.model = W.load_program(pcfg, W.draw(cfg, run.seed, run.device),
                              grad=False)
    st.caches = M.init_caches(pcfg, b, mix["max_len"], device=run.device)
    st.serve = steps.make_serve_step(pcfg)
    if "unchanged" in run.faults:
        st.patches.set(M, "_store", lambda caches, key, li, new: None)
    st.prompt = data.tokens(run.seed, 0, 0, (b, p), cfg["vocab_size"])
    prompt = data.to_device(st.prompt, run.device)
    st.cache_len = torch.zeros((b,), dtype=torch.int32, device=run.device)
    for pos in range(p):
        st.tok = _serve(run, st, prompt[:, pos:pos + 1])
    st.served = [st.tok.cpu().numpy()[:, 0]]
    return st


def window(run, st) -> Dict:
    b, p = run.mix["batch"], run.mix["prompt"]

    def body(i: int) -> None:
        with run.phase("step"):
            st.tok = _serve(run, st, st.tok, i)
        with run.phase("read"):
            st.served.append(st.tok.cpu().numpy()[:, 0])

    t0, ends = run.closed_loop(body, run.mix["trace_steps"])
    gaps = np.diff(np.array([t0] + ends))
    k = run.mix["trace_steps"]
    rest = gaps[2 * k:] if run.trace else gaps
    p95 = float(np.percentile(rest, 95)) * 1e3 if len(rest) else None
    run.traced = {"steps": k, "tokens": k * b, "token_gap_ms_p95": p95,
                  "model_flops": sum(counts.decode_flops(run.cfg, b, p + i)
                                     for i in range(k))}
    return {"metrics": {
        "decode_tokens_per_s": len(ends) * b / (ends[-1] - t0)},
        "attempted": len(ends) * b, "failed": 0}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest relative distance over the two leading dims."""
    diff = torch.linalg.vector_norm((a - b).flatten(2), dim=-1)
    return float((diff / torch.linalg.vector_norm(b.flatten(2), dim=-1)
                  .clamp(min=1e-30)).max())


def _reference(run, st, precision: str):
    """(logits [rows, T, V], ssm states [L, rows, di, N], conv inputs [L,
    rows, kc - 1, di]) over the sampled sequences' fed tokens."""
    weights = W.draw(run.cfg, run.seed, run.device)
    states: list = []
    with torch.no_grad(), exact_fp32():
        fed = torch.from_numpy(st.fed).to(run.device)
        h = reference.hidden(weights, run.cfg, fed, precision, states=states)
        logits = reference.logits(weights, run.cfg, h, precision)
    del weights, h
    ssm = torch.stack([s for s, _ in states])
    conv = torch.stack([c for _, c in states])
    run.free()
    return logits, ssm, conv


def _token_gap(ref_logits: torch.Tensor, served: np.ndarray, p: int
               ) -> float:
    """served [rows, n]: the token chosen at positions p - 1 .. p + n - 2."""
    at = ref_logits[:, p - 1: p - 1 + served.shape[1]]
    chosen = torch.gather(at, -1, torch.from_numpy(served).long()
                          .to(at.device)[..., None])[..., 0]
    return float((at.max(dim=-1).values - chosen).max())


def check(run, st) -> Dict[str, float]:
    mix = run.mix
    p = mix["prompt"]
    rows = sample(run.seed, mix["batch"], mix["check_rows"])
    served = np.stack(st.served, axis=1)[rows]          # [rows, n]
    st.fed = np.concatenate([st.prompt[rows], served[:, :-1]], axis=1)
    st.check_served = served
    idx = torch.tensor(rows, device=run.device)
    prog_ssm = st.caches["ssm"][:, idx].float()
    prog_conv = st.caches["conv"][:, idx].float()
    st.patches.undo()
    del st.model, st.caches, st.serve
    run.free()
    st.ref = _reference(run, st, "fp32")
    logits, ssm, conv = st.ref
    return {"token_gap": _token_gap(logits, served, p),
            "ssm_gap": _rel(prog_ssm, ssm),
            "conv_gap": _rel(prog_conv, conv)}


def control(run, st) -> Dict[str, float]:
    """The reference in float8 in the program's place (after ``check``):
    at each served position the token it puts first, and its states."""
    logits, ssm, conv = _reference(run, st, "fp8")
    ref_logits, ref_ssm, ref_conv = st.ref
    p = run.mix["prompt"]
    n = st.check_served.shape[1]
    first = logits[:, p - 1: p - 1 + n].argmax(dim=-1).cpu().numpy()
    return {"token_gap": _token_gap(ref_logits, first, p),
            "ssm_gap": _rel(ssm, ref_ssm), "conv_gap": _rel(conv, ref_conv)}
