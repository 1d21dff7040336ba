"""Serving steps, as the reference's ``models/steps.py`` makes them.

``make_prefill_step`` returns the no-grad forward that projects only the
last position to the vocabulary (the [B, S, V] logits are never formed);
``make_serve_step`` the one-token decode step against dense caches with a
greedy next token.  The loss, the train step and AdamW come with the
training slice.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..config import ModelConfig
from . import layers as L
from . import model as M


def make_prefill_step(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(model: M.Model, batch: Dict) -> torch.Tensor:
        """batch["tokens"] [B, S] -> next-token logits [B, V]."""
        hidden = M.forward(cfg, model, batch, return_hidden=True)
        return L.matmul(hidden[:, -1, :], M.lm_head(cfg, model))
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    @torch.no_grad()
    def serve_step(model: M.Model, token: torch.Tensor,
                   cache_len: torch.Tensor, caches: Dict[str, torch.Tensor]):
        """token [B, 1], cache_len [B] -> (next token int32 [B, 1], logits
        [B, 1, V], new caches)."""
        logits, caches = M.decode_step(cfg, model, token, cache_len, caches)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], logits, caches
    return serve_step
