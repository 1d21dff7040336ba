"""Prefill driver: a closed loop of the port's prefill step
(``models/steps.py::make_prefill_step``), each call ``batch`` prompts of
``seq`` tokens drawn from the seed (a stream of their own, a new set a
call), moved through pinned memory without blocking; each call returns
the last position's logits and ends when its first tokens (their argmax)
reach the host.  Set-up warms the one shape with ``warmup`` calls on
prompts of another stream.

End-to-end: ``prefill_tokens_per_s``, every prompt token prefilled over
the window.

The check keeps every call's logits, samples ``check_calls`` calls from
the seed once the window has closed, frees the program and runs the
reference over their prompts, ``check_rows`` rows at a time:
- ``logit_err``: the worst prompt's largest |logit - reference| over the
  reference's largest |logit|.

Planted faults: ``half_batch`` (the step prefills the first half of the
prompts; the rest get copies of their logits), ``token_altered`` (every
call hands its first prompt the second prompt's logits).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict

import torch

from port_bench import data, weights as W
from port_bench.counts import model as counts
from port_bench.reference import model as reference
from port_bench.traffic.common import exact_fp32, sample

STREAM, WARMUP_STREAM = 1, 2


def _prompts(run, stream: int, i: int) -> torch.Tensor:
    mix = run.mix
    return data.to_device(data.tokens(run.seed, stream, i,
                                      (mix["batch"], mix["seq"]),
                                      run.cfg["vocab_size"]), run.device)


def _prefill(run, st, tokens: torch.Tensor) -> torch.Tensor:
    if "half_batch" in run.faults:
        h = tokens.shape[0] // 2
        out = st.prefill(st.model, {"tokens": tokens[:h]})
        out = torch.cat([out, out[: tokens.shape[0] - h]])
    else:
        out = st.prefill(st.model, {"tokens": tokens})
    if "token_altered" in run.faults:
        out = out.clone()
        out[0] = out[1]
    return out


def setup(run):
    from repro_torch.models import steps
    st = SimpleNamespace(outs=[])
    st.model = W.load_program(run.program_config(),
                              W.draw(run.cfg, run.seed, run.device),
                              grad=False)
    st.prefill = steps.make_prefill_step(run.program_config())
    for i in range(run.mix["warmup"]):
        _prefill(run, st, _prompts(run, WARMUP_STREAM, i)).argmax(-1).cpu()
    return st


def window(run, st) -> Dict:
    b, s = run.mix["batch"], run.mix["seq"]

    def body(i: int) -> None:
        with run.phase("feed"):
            tokens = _prompts(run, STREAM, i)
        with run.phase("step"):
            out = _prefill(run, st, tokens)
        with run.phase("read"):
            out.argmax(dim=-1).cpu()
        st.outs.append(out)

    t0, ends = run.closed_loop(body, run.mix["trace_steps"])
    k = run.mix["trace_steps"]
    run.traced = {"steps": k, "tokens": k * b * s,
                  "model_flops": k * counts.prefill_flops(run.cfg, b, s)}
    return {"metrics": {"prefill_tokens_per_s": len(ends) * b * s
                        / (ends[-1] - t0)},
            "attempted": len(ends) * b, "failed": 0}


def _reference(run, st, precision: str) -> torch.Tensor:
    """The reference's last-position logits of the sampled calls' prompts
    [calls * batch, V]."""
    weights = W.draw(run.cfg, run.seed, run.device)
    rows = run.mix["check_rows"]
    out = []
    with torch.no_grad(), exact_fp32():
        for i in st.picked:
            tokens = _prompts(run, STREAM, i)
            for r in range(0, tokens.shape[0], rows):
                h = reference.hidden(weights, run.cfg, tokens[r:r + rows],
                                     precision)
                out.append(reference.logits(weights, run.cfg, h[:, -1],
                                            precision))
                del h
    del weights
    run.free()
    return torch.cat(out)


def _err(prog: torch.Tensor, ref: torch.Tensor) -> float:
    return float(((prog - ref).abs().amax(dim=-1)
                  / ref.abs().amax(dim=-1)).max())


def check(run, st) -> Dict[str, float]:
    st.picked = sample(run.seed, len(st.outs), run.mix["check_calls"])
    prog = torch.cat([st.outs[i].float() for i in st.picked])
    del st.model, st.prefill, st.outs
    run.free()
    st.ref = _reference(run, st, "fp32")
    return {"logit_err": _err(prog, st.ref)}


def control(run, st) -> Dict[str, float]:
    """The reference in float8 in the program's place (after ``check``)."""
    return {"logit_err": _err(_reference(run, st, "fp8"), st.ref)}
