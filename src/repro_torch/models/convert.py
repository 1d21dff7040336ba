"""Carry the reference's parameters over into the port's ``Model``.

The reference keeps a parameter tree of arrays with the layers stacked on
a leading axis (``params["layers"]["attn"]["wq"][li]``); the port keeps a
``ModuleList`` of layers.  ``from_reference`` takes that tree with numpy
arrays as leaves and returns a ``Model`` holding the same values in the
same dtypes (fp32 leaves such as Mamba's ``A_log`` and ``D`` stay fp32).
bf16 arrives as an ``ml_dtypes.bfloat16`` numpy array, which
``torch.from_numpy`` does not take: it crosses as float32, which holds
every bf16 value exactly.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import ModelConfig
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
