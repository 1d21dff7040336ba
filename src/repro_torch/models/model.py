"""Model assembly for the dense decoder family.

``Model`` holds the embedding, one ``DecoderLayer`` per layer in a
``ModuleList`` (the reference stacks them on a leading axis for
``lax.scan``; here layer ``li`` is ``model.layers[li]``), the final norm
and the untied LM head.  It is initialised from a ``torch.Generator`` on
the given device, in bf16 like the reference.  The serving engine runs the
layers itself, token by token against the paged KV pool; the reference's
``forward`` / ``decode_step`` and the other families come with later
slices.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig
from . import layers as L


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.attn_norm = L._ones((cfg.d_model,), device)
        self.mlp_norm = L._ones((cfg.d_model,), device)
        self.attn = L.init_attention(cfg, gen, device)
        self.mlp = L.init_mlp(cfg, gen, device)


class Model(nn.Module):
    """Dense decoder parameters.  ``generator=None`` leaves the storage
    uninitialised, for ``models.convert`` to fill."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        if cfg.family != "dense":
            raise ValueError(f"{cfg.name}: family {cfg.family!r}; the port "
                             "has the dense family only so far")
        self.cfg = cfg
        gen = generator
        self.embed = L._dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                   device, scale_axis=1)
        self.final_norm = L._ones((cfg.d_model,), device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, gen, device)
                                    for _ in range(cfg.num_layers))
        self.lm_head = None if cfg.tie_embeddings else L._dense_init(
            gen, (cfg.d_model, cfg.vocab_size), device)


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda",
               dtype: torch.dtype = L.DTYPE) -> Model:
    """A model with random weights drawn on ``device`` from a generator
    seeded with ``seed``, cast to ``dtype``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return Model(cfg, generator=gen, device=device).to(dtype)


def lm_head(cfg: ModelConfig, model: Model) -> torch.Tensor:
    return model.embed.T if cfg.tie_embeddings else model.lm_head
