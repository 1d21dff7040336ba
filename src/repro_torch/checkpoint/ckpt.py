"""Checkpointing: atomic, async-capable, in the reference's on-disk layout.

Layout per step, as the reference writes it:
  <dir>/step_<N>.tmp/   -> written, then atomically renamed to
  <dir>/step_<N>/
      manifest.json     {"step", "leaves": {key: {shape, dtype}}}
      arrays.npz        the leaves, keyed by tree path with "/" -> "__"

A key is the reference's tree path of the leaf: ``params/<path>`` for a
parameter, ``opt/.step`` and ``opt/.{master,mu,nu}/<path>`` for the
optimizer, with the layers' tensors stacked on a leading axis
(``params/layers/attn/wq`` is [L, d, H * hd]; ``models.convert`` maps the
port's parameter names to these paths).  Keys come in the reference's
order, dtype names are numpy's (``bfloat16``, ``float32``, ``int32``),
and bf16 is widened to fp32 in the npz, which holds every bf16 value
exactly.  So a checkpoint written by either package restores in the
other.

``restore`` casts every leaf to the dtype of the structure it is given,
as the reference casts to its ``state_shapes``: given
``models.steps.state_shapes(cfg)`` (a fresh state), Mamba's ``A_log`` and
``D`` come back fp32 whatever the checkpoint holds.  ``save_async``
snapshots to host memory at once (consistency) and writes in a thread.
numpy and json only.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..models.convert import reference_path, stack_layers
from ..models.model import Model
from ..optim.adamw import OptState

OPT_FIELDS = ("master", "mu", "nu")

Leaf = Tuple[str, np.ndarray, str]      # (key, host array, dtype name)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[-1]


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that npz takes: bf16 widened to fp32."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _groups(state: Dict) -> Iterator[Tuple[str, Dict[str, torch.Tensor]]]:
    """(key prefix, tensors by port name) for the state's parameter trees,
    in the reference's order: the optimizer's fields, then the
    parameters."""
    opt = state["opt"]
    for field in OPT_FIELDS:
        yield f"opt/.{field}", getattr(opt, field)
    yield "params", dict(state["model"].named_parameters())


def _flatten(state: Dict) -> List[Leaf]:
    """Every leaf of ``state`` on the host, keyed and ordered as the
    reference flattens its state (dict keys sorted, the optimizer's
    fields in order)."""
    out = [("opt/.step", _host(state["opt"].step),
            _dtype_name(state["opt"].step))]
    for prefix, tensors in _groups(state):
        names = {reference_path(n)[0]: n for n in tensors}
        arrays = stack_layers((n, _host(t)) for n, t in tensors.items())
        out += [(f"{prefix}/{path}", arrays[path],
                 _dtype_name(tensors[names[path]]))
                for path in sorted(arrays)]
    return out


def save(state: Dict, step: int, ckpt_dir: str, keep_last: int = 3) -> Path:
    """Synchronous atomic checkpoint."""
    return _write(_flatten(state), step, ckpt_dir, keep_last)


def save_async(state: Dict, step: int, ckpt_dir: str,
               keep_last: int = 3) -> threading.Thread:
    """Snapshot to host now; write in the background."""
    flat = _flatten(state)                  # consistent snapshot
    t = threading.Thread(target=_write,
                         args=(flat, step, ckpt_dir, keep_last), daemon=True)
    t.start()
    return t


def _write(flat: List[Leaf], step: int, ckpt_dir: str,
           keep_last: int) -> Path:
    base = Path(ckpt_dir)
    base.mkdir(parents=True, exist_ok=True)
    tmp = base / f"step_{step}.tmp"
    final = base / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(a.shape), "dtype": dtype}
                   for k, a, dtype in flat},
    }
    np.savez(tmp / "arrays.npz", **{k.replace("/", "__"): a
                                    for k, a, _ in flat})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)          # atomic publish
    _prune(base, keep_last)
    return final


def _prune(base: Path, keep_last: int) -> None:
    steps = sorted((int(p.name.split("_")[1]), p)
                   for p in base.glob("step_*") if p.is_dir()
                   and not p.name.endswith(".tmp"))
    for _, p in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    base = Path(ckpt_dir)
    if not base.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in base.glob("step_*")
             if p.is_dir() and not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def restore(like: Dict, ckpt_dir: str, step: Optional[int] = None,
            device=None) -> Tuple[Dict, int]:
    """Restore into the structure of ``like`` (a state such as
    ``state_shapes(cfg)`` gives, on any device, meta included): a new
    state on ``device`` (default: ``like``'s) whose every leaf has
    ``like``'s shape and dtype.  Returns (state, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step}"
    model = like["model"]
    nl = model.cfg.num_layers
    device = torch.device(device) if device is not None \
        else like["opt"].step.device
    if device.type == "meta":
        raise ValueError("restore needs a device to put the state on")
    loaded: Dict[str, np.ndarray] = {}     # an npz reads a key per access
    with np.load(d / "arrays.npz") as data:
        def leaf(key: str, li: Optional[int], t: torch.Tensor):
            if key not in loaded:
                loaded[key] = data[key.replace("/", "__")]
            arr = loaded[key]
            expect = tuple(t.shape) if li is None else (nl, *t.shape)
            if tuple(arr.shape) != expect:
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {expect}")
            arr = arr if li is None else arr[li]
            return torch.from_numpy(np.array(arr)).to(
                device, t.dtype)

        trees = {}
        for prefix, tensors in _groups(like):
            trees[prefix] = {n: leaf(f"{prefix}/{path}", li, t)
                             for n, t in tensors.items()
                             for path, li in [reference_path(n)]}
        opt_step = leaf("opt/.step", None, like["opt"].step)
    new_model = Model(model.cfg, device="meta")
    new_model.load_state_dict(trees["params"], assign=True)
    opt = OptState(step=opt_step,
                   **{f: trees[f"opt/.{f}"] for f in OPT_FIELDS})
    return {"model": new_model, "opt": opt}, step
