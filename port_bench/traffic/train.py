"""Training driver: a closed loop of the port's train step
(``models/steps.py::make_train_step``), one batch of ``batch`` rows of
``seq`` tokens a step from the benchmark's copy of ``SyntheticLM``,
moved through pinned memory without blocking; each step ends in a read
of its loss, as a training job logs it.

Set-up builds the model from the benchmark's weights and its AdamW state
(``optim/adamw.py::init``) and drives the same objects through the first
``checked_steps`` steps, through the window's own call and feed: the
warm-up, and what the check reads (each leaf's norm of
the first step's clipped gradient, as ``mu / (1 - beta1)`` after it; each
master's change after the last).  The window then goes on from there.

The check runs the reference (``reference/train.py``) from the same
weights on the same batches, once the program's state is freed, and
compares:
- ``grad_gap``: the worst leaf's gap of first-step gradient norms;
- ``change_gap``: the worst leaf's gap of change norms, over leaves whose
  reference gradient is at least a thousandth of the median leaf's.
Each step's loss is not compared: over 14 seeds its gap read up to
1.7e-4 of the loss, the float8 control's as little as 2.2e-4 and no
fault's ten times that, so no limit could tell them apart.

Planted faults (``run.faults``): ``unchanged`` (the optimizer returns
the state as it was), ``half_batch`` (the step sees the first half of the
rows: the mean over the rest), ``token_altered`` (one token of every
batch changed where the data is produced).
"""
from __future__ import annotations

import statistics
from types import SimpleNamespace
from typing import Dict

import torch

from port_bench import data, weights as W
from port_bench.counts import model as counts
from port_bench.reference import train as reference
from port_bench.traffic.common import Patches, exact_fp32, norm_gap


def _feed(run, st, i: int) -> Dict[str, torch.Tensor]:
    batch = st.data.batch_at(i)
    if "half_batch" in run.faults:
        batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
    if "token_altered" in run.faults:
        batch["tokens"][0, 1] = (batch["tokens"][0, 1] + 1) \
            % run.cfg["vocab_size"]
    return {k: data.to_device(v, run.device) for k, v in batch.items()}


def _step(run, st, i: int) -> float:
    with run.phase("feed"):
        batch = _feed(run, st, i)
    with run.phase("step"):
        st.state, metrics = st.step(st.state, batch)
    with run.phase("read"):
        return float(metrics["loss"])


def _frozen_update(adamw):
    """An optimizer that returns the state it was given."""
    def update(grads, state, tc):
        params = {n: m.to(torch.bfloat16) for n, m in state.master.items()}
        return params, state, {"grad_norm": adamw.global_norm(
            grads.values()), "lr": torch.zeros(())}
    return update


def setup(run):
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.models import steps
    from repro_torch.optim import adamw
    cfg, mix = run.cfg, run.mix
    pcfg = run.program_config()
    st = SimpleNamespace(patches=Patches())
    model = W.load_program(pcfg, W.draw(cfg, run.seed, run.device),
                           grad=True)
    st.state = {"model": model,
                "opt": adamw.init(dict(model.named_parameters()))}
    st.step = steps.make_train_step(
        pcfg, TrainConfig(**mix["optimizer"]),
        ParallelConfig(remat=mix["remat"], grad_accum=mix["grad_accum"]))
    if "unchanged" in run.faults:
        st.patches.set(adamw, "update", _frozen_update(adamw))
    st.data = data.SyntheticLM(cfg["vocab_size"], mix["batch"], mix["seq"],
                               run.seed)
    b1 = mix["optimizer"]["beta1"]
    st.prog = {}
    for k in range(mix["checked_steps"]):
        _step(run, st, k)
        if k == 0:
            st.prog["grad"] = {
                n: float(torch.linalg.vector_norm(m)) / (1 - b1)
                for n, m in st.state["opt"].mu.items()}
    start = W.draw(cfg, run.seed, run.device)
    st.prog["change"] = {
        n: float(torch.linalg.vector_norm(m - start[n].to(torch.float32)))
        for n, m in st.state["opt"].master.items()}
    del start
    return st


def window(run, st) -> Dict:
    b, s = run.mix["batch"], run.mix["seq"]
    first = run.mix["checked_steps"]
    t0, ends = run.closed_loop(lambda i: _step(run, st, first + i),
                               run.mix["trace_steps"])
    k = run.mix["trace_steps"]
    run.traced = {"steps": k, "tokens": k * b * s,
                  "model_flops": k * counts.train_flops(run.cfg, b, s)}
    return {"metrics": {"train_tokens_per_s": len(ends) * b * s
                        / (ends[-1] - t0)},
            "attempted": len(ends), "failed": 0}


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    names = sorted(ref["grad"])
    grad_gap = norm_gap(prog["grad"], ref["grad"], names)
    med = statistics.median(ref["grad"][n] for n in names)
    moved = [n for n in names if ref["grad"][n] >= 1e-3 * med]
    change_gap = norm_gap(prog["change"], ref["change"], moved)
    return {"grad_gap": grad_gap, "change_gap": change_gap}


def _reference(run, precision: str) -> Dict:
    mix = run.mix
    feed = data.SyntheticLM(run.cfg["vocab_size"], mix["batch"], mix["seq"],
                            run.seed)
    batches = [{k: data.to_device(v, run.device)
                for k, v in feed.batch_at(i).items()}
               for i in range(mix["checked_steps"])]
    weights = W.draw(run.cfg, run.seed, run.device)
    with exact_fp32():
        out = reference.readings(run.cfg, weights, batches,
                                 mix["optimizer"], precision)
    del weights, batches
    run.free()
    return out


def check(run, st) -> Dict[str, float]:
    """Frees the program's state, then holds its readings against the
    reference's."""
    st.patches.undo()
    del st.state, st.step
    run.free()
    st.ref = _reference(run, "fp32")
    return compare(st.prog, st.ref)


def control(run, st) -> Dict[str, float]:
    """The reference in float8 in the program's place (after ``check``)."""
    return compare(_reference(run, "fp8"), st.ref)
