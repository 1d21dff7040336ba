"""Shape stand-ins for every model input, on the meta device: what the
reference's ``launch/specs.py`` gives as ``ShapeDtypeStruct``s.

``input_specs(cfg, shape)`` returns the arguments of the step of that
shape's kind:
  train   -> {"state", "batch"}                          for train_step
  prefill -> {"params", "batch"}                         for prefill_step
  decode  -> {"params", "token", "cache_len", "caches"}  for serve_step
``params`` is a ``Model`` on the meta device (``param_shapes``), whose
per-layer parameters are the reference's stacked ones without the layer
axis.  The modality frontends are stubs, as there: whisper gets frame
embeddings, internvl patch embeddings.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..config import ModelConfig, ShapeSpec
from ..models import model as M
from ..models import steps as S


def sds(shape, dtype: torch.dtype) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` on the meta device."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs_shapes(cfg: ModelConfig, shape: ShapeSpec) -> Dict:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": sds((b, s), torch.int32)}
    if shape.kind == "train":
        batch["targets"] = sds((b, s), torch.int32)
    if cfg.encoder_layers:
        batch["frames"] = sds((b, cfg.encoder_seq, cfg.d_model),
                              torch.bfloat16)
    if cfg.vision_prefix:
        batch["vision_embeds"] = sds((b, cfg.vision_prefix, cfg.d_model),
                                     torch.bfloat16)
    return batch


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict:
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        batch = batch_specs_shapes(cfg, shape)
        if shape.kind == "train":
            return {"state": S.state_shapes(cfg), "batch": batch}
        return {"params": M.param_shapes(cfg), "batch": batch}
    # decode: one new token against caches of length seq_len
    return {
        "params": M.param_shapes(cfg),
        "token": sds((b, 1), torch.int32),
        "cache_len": sds((b,), torch.int32),
        "caches": M.init_caches(cfg, b, s, device="meta"),
    }
