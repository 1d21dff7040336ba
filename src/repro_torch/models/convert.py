"""Carry the reference's parameters and train state over into the port's.

The reference keeps a parameter tree of arrays with the layers stacked on
a leading axis (``params["layers"]["attn"]["wq"][li]``); the port keeps a
``ModuleList`` of layers.  ``from_reference`` takes that tree with numpy
arrays as leaves and returns a ``Model`` holding the same values in the
same dtypes (fp32 leaves such as Mamba's ``A_log`` and ``D`` stay fp32).
``state_from_reference`` does the same for a whole train state (``params``
and ``opt``: step, master, mu, nu).  bf16 arrives as an
``ml_dtypes.bfloat16`` numpy array, which ``torch.from_numpy`` does not
take: it crosses as float32, which holds every bf16 value exactly.

The other way, ``reference_path`` names the reference's tree path of a
port parameter and ``stack_layers`` stacks per-layer arrays as the
reference holds them: the checkpoint layout (``checkpoint/ckpt.py``).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..optim.adamw import OptState
from .model import Model


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    dtype = torch.bfloat16 if a.dtype.name == "bfloat16" else {
        np.dtype(np.float32): torch.float32,
        np.dtype(np.float16): torch.float16}[a.dtype]
    return torch.from_numpy(np.array(a, np.float32)).to(device, dtype)


def reference_leaf(params: Dict, name: str) -> np.ndarray:
    """The reference's array for the port's parameter ``name`` (as
    ``Model.named_parameters`` gives it): ``layers.<li>.attn.wq`` is
    ``params["layers"]["attn"]["wq"][li]``."""
    parts = name.split(".")
    if parts[0] != "layers":
        return params[parts[0]]
    node = params["layers"]
    for key in parts[2:]:
        node = node[key]
    return node[int(parts[1])]


def from_reference(cfg: ModelConfig, params: Dict,
                   device="cuda") -> Model:
    """A ``Model`` on ``device`` holding the reference tree's values."""
    model = Model(cfg, device="meta")
    state = {name: _tensor(np.asarray(reference_leaf(params, name)), device)
             for name, _ in model.named_parameters()}
    missing = set(params) - {"embed", "final_norm", "layers", "lm_head"}
    if missing:
        raise ValueError(f"reference parameters not in the port's "
                         f"model: {sorted(missing)}")
    model.load_state_dict(state, assign=True)
    return model


def reference_path(name: str) -> Tuple[str, Optional[int]]:
    """The reference's "/"-joined tree path of the port's parameter
    ``name`` and its layer index (None outside the layers):
    ``layers.3.attn.wq`` is (``layers/attn/wq``, 3)."""
    parts = name.split(".")
    if parts[0] != "layers":
        return "/".join(parts), None
    return "/".join(["layers"] + parts[2:]), int(parts[1])


def stack_layers(named: Iterable[Tuple[str, np.ndarray]]
                 ) -> Dict[str, np.ndarray]:
    """Arrays by port name -> arrays by reference path, each layer's
    array stacked on a leading axis in layer order."""
    out: Dict[str, np.ndarray] = {}
    layers: Dict[str, Dict[int, np.ndarray]] = {}
    for name, arr in named:
        path, li = reference_path(name)
        if li is None:
            out[path] = arr
        else:
            layers.setdefault(path, {})[li] = arr
    for path, by_layer in layers.items():
        out[path] = np.stack([by_layer[i] for i in range(len(by_layer))])
    return out


def state_from_reference(cfg: ModelConfig, state: Dict,
                         device="cuda") -> Dict:
    """The port's train state ``{"model", "opt"}`` on ``device`` holding a
    reference train state's values (``state["params"]``, the tree
    ``from_reference`` takes, and ``state["opt"]`` with ``step``,
    ``master``, ``mu`` and ``nu`` trees of the same structure), in the
    same dtypes."""
    model = from_reference(cfg, state["params"], device)
    opt = state["opt"]
    names = [n for n, _ in model.named_parameters()]

    def tree(t) -> Dict[str, torch.Tensor]:
        return {n: _tensor(np.asarray(reference_leaf(t, n)), device)
                for n in names}

    step = torch.from_numpy(np.array(opt.step, np.int32)).to(device)
    return {"model": model,
            "opt": OptState(step=step, master=tree(opt.master),
                            mu=tree(opt.mu), nu=tree(opt.nu))}
