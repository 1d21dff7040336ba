"""Model assembly for the dense, ssm and hybrid families.

``Model`` holds the embedding, one ``DecoderLayer`` per layer in a
``ModuleList`` (the reference stacks them on a leading axis for
``lax.scan``; here layer ``li`` is ``model.layers[li]`` and the layers run
in a Python loop), the final norm and the untied LM head.  It is
initialised from a ``torch.Generator`` on the given device, in bf16 like
the reference, with Mamba's ``A_log`` and ``D`` in fp32.

Entry points, as in the reference:
  forward(cfg, model, batch, remat)            -> logits  (train, prefill)
  decode_step(cfg, model, token, len, caches)  -> logits, caches
  init_caches(cfg, batch, max_len)             -> dense decode caches
The serving engine (``serving/engine.py``) runs the dense layers itself
against its paged KV pool.  The ``moe``, ``encdec`` and ``vlm`` families
come with later slices.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from . import layers as L

FAMILIES = ("dense", "ssm", "hybrid")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not in the "
                         f"port yet; it has {', '.join(FAMILIES)}")


class DecoderLayer(nn.Module):
    """Norms and blocks of one layer, named as the reference's: ``attn``
    except in the ssm family, ``mlp`` when d_ff > 0, ``ssm_norm`` and
    ``ssm`` in the ssm and hybrid families."""

    def __init__(self, cfg: ModelConfig,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.attn_norm = L._ones((cfg.d_model,), device)
        self.mlp_norm = L._ones((cfg.d_model,), device)
        if cfg.family != "ssm":
            self.attn = L.init_attention(cfg, gen, device)
        if cfg.d_ff > 0:
            self.mlp = L.init_mlp(cfg, gen, device)
        if cfg.has_ssm:
            self.ssm_norm = L._ones((cfg.d_model,), device)
            self.ssm = L.init_mamba(cfg, gen, device)


class Model(nn.Module):
    """Decoder parameters.  ``generator=None`` leaves the storage
    uninitialised, for ``models.convert`` to fill."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        check_family(cfg)
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
    seeded with ``seed``.  The parameters the reference draws in bf16 are
    cast to ``dtype``; the fp32 ones (Mamba's ``A_log`` and ``D``) stay
    fp32."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = Model(cfg, generator=gen, device=device)
    for p in model.parameters():
        if p.dtype == L.DTYPE:
            p.data = p.data.to(dtype)
    return model


def lm_head(cfg: ModelConfig, model: Model) -> torch.Tensor:
    return model.embed.T if cfg.tie_embeddings else model.lm_head


# ======================================================================
# per-layer window schedule (hybrid archs)
# ======================================================================
def layer_windows(cfg: ModelConfig) -> Optional[np.ndarray]:
    """Per-layer sliding-window size; 0 = full attention.  The
    ``full_attn_layers`` indices are taken modulo the depth, as in the
    reference, so a model cut in depth keeps full layers."""
    if not cfg.has_attention:
        return None
    if cfg.full_attn_layers:
        w = np.full((cfg.num_layers,), cfg.sliding_window or 0, np.int32)
        for i in cfg.full_attn_layers:
            w[i % cfg.num_layers] = 0
        return w
    if cfg.sliding_window:
        return np.full((cfg.num_layers,), cfg.sliding_window, np.int32)
    return np.zeros((cfg.num_layers,), np.int32)


def _windows(cfg: ModelConfig):
    """Each layer's window for ``layers.attention``: None for full."""
    w = layer_windows(cfg)
    return [None] * cfg.num_layers if w is None \
        else [int(v) or None for v in w]


# ======================================================================
# forward (prefill)
# ======================================================================
def embed_inputs(cfg: ModelConfig, model: Model,
                 batch: Dict) -> torch.Tensor:
    """batch["tokens"]: int [B, S] -> [B, S, d]."""
    if cfg.vision_prefix:
        raise ValueError(f"{cfg.name}: the VLM prefix is not in the port "
                         "yet")
    return model.embed[batch["tokens"].long()]


def _block(cfg: ModelConfig, x: torch.Tensor, layer: DecoderLayer,
           positions: torch.Tensor, window: Optional[int]) -> torch.Tensor:
    eps = cfg.norm_eps
    if cfg.family == "ssm":
        x = x + L.mamba(layer.ssm, cfg, L.rms_norm(x, layer.ssm_norm, eps))
    elif cfg.family == "hybrid":
        # parallel attention + SSM heads over the same normed input (Hymba)
        h = L.rms_norm(x, layer.attn_norm, eps)
        attn_out = L.attention(layer.attn, cfg, h, positions, window)
        ssm_out = L.mamba(layer.ssm, cfg, L.rms_norm(x, layer.ssm_norm, eps))
        x = x + attn_out + ssm_out
    else:
        h = L.rms_norm(x, layer.attn_norm, eps)
        x = x + L.attention(layer.attn, cfg, h, positions, window)
    if cfg.d_ff > 0:
        h = L.rms_norm(x, layer.mlp_norm, eps)
        x = x + L.mlp(layer.mlp, cfg, h)
    return x


def forward(cfg: ModelConfig, model: Model, batch: Dict,
            remat: bool = True, return_hidden: bool = False) -> torch.Tensor:
    """Training / prefill forward -> logits [B, S, V] (or the
    final-normed hidden states [B, S, d] when ``return_hidden``).  With
    ``remat`` and grad mode on, each layer runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
    scanned layer): only the layer inputs are kept, and the backward runs
    each layer's forward again, its kernels included."""
    check_family(cfg)
    x = embed_inputs(cfg, model, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    remat = remat and torch.is_grad_enabled()
    for layer, window in zip(model.layers, _windows(cfg)):
        if remat:
            x = checkpoint(_block, cfg, x, layer, positions, window,
                           use_reentrant=False)
        else:
            x = _block(cfg, x, layer, positions, window)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    if return_hidden:
        return x
    return L.matmul(x, lm_head(cfg, model))


# ======================================================================
# decode (serve_step)
# ======================================================================
def init_caches(cfg: ModelConfig, batch_size: int, max_len: int,
                device="cuda") -> Dict[str, torch.Tensor]:
    """Dense decode caches on ``device``, stacked over layers: ``k``/``v``
    [L, B, S, KV, D] bf16 for attention (S = max_len, or the window for a
    sliding-window model without full layers: a ring buffer), ``conv``
    [L, B, kc - 1, di] bf16 and ``ssm`` [L, B, di, N] fp32 for Mamba,
    whatever the weights' dtype, as in the reference."""
    check_family(cfg)
    nl = cfg.num_layers
    caches: Dict[str, torch.Tensor] = {}
    if cfg.has_attention:
        s = max_len
        if cfg.sliding_window and not cfg.full_attn_layers:
            s = min(max_len, cfg.sliding_window)
        caches["k"] = torch.zeros(
            (nl, batch_size, s, cfg.num_kv_heads, cfg.head_dim_),
            dtype=L.DTYPE, device=device)
        caches["v"] = torch.zeros_like(caches["k"])
    if cfg.has_ssm:
        caches["conv"] = torch.zeros(
            (nl, batch_size, cfg.ssm_conv - 1, cfg.d_inner_), dtype=L.DTYPE,
            device=device)
        caches["ssm"] = torch.zeros(
            (nl, batch_size, cfg.d_inner_, cfg.ssm_state),
            dtype=torch.float32, device=device)
    return caches


def _store(caches: Dict[str, torch.Tensor], key: str, li: int,
           new: torch.Tensor) -> None:
    """Write layer ``li``'s new state into the stacked cache in place.  A
    cache whose dtype the step promotes (the bf16 conv cache under fp32
    weights, as in the reference) is cast once first."""
    if caches[key].dtype != new.dtype:
        caches[key] = caches[key].to(new.dtype)
    caches[key][li] = new


def _mamba_decode(cfg: ModelConfig, layer: DecoderLayer, h: torch.Tensor,
                  caches: Dict[str, torch.Tensor], li: int) -> torch.Tensor:
    y, conv, ssm = L.mamba_decode(layer.ssm, cfg, h, caches["conv"][li],
                                  caches["ssm"][li])
    _store(caches, "conv", li, conv)
    _store(caches, "ssm", li, ssm)
    return y


def _decode_block(cfg: ModelConfig, x: torch.Tensor, layer: DecoderLayer,
                  caches: Dict[str, torch.Tensor], li: int,
                  cache_len: torch.Tensor) -> torch.Tensor:
    """Layer ``li`` of one decode step; its caches are updated in place
    (attention writes the new token's k/v slot into the stacked cache)."""
    eps = cfg.norm_eps
    if cfg.family == "ssm":
        h = L.rms_norm(x, layer.ssm_norm, eps)
        x = x + _mamba_decode(cfg, layer, h, caches, li)
    elif cfg.family == "hybrid":
        # parallel attention + SSM heads over the same input (Hymba)
        h = L.rms_norm(x, layer.attn_norm, eps)
        attn_out, _, _ = L.attention_decode(
            layer.attn, cfg, h, caches["k"][li], caches["v"][li], cache_len)
        h2 = L.rms_norm(x, layer.ssm_norm, eps)
        x = x + attn_out + _mamba_decode(cfg, layer, h2, caches, li)
    else:
        h = L.rms_norm(x, layer.attn_norm, eps)
        out, _, _ = L.attention_decode(
            layer.attn, cfg, h, caches["k"][li], caches["v"][li], cache_len)
        x = x + out
    if cfg.d_ff > 0:
        h = L.rms_norm(x, layer.mlp_norm, eps)
        x = x + L.mlp(layer.mlp, cfg, h)
    return x


def decode_step(cfg: ModelConfig, model: Model, token: torch.Tensor,
                cache_len: torch.Tensor, caches: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step: token int [B, 1], cache_len int [B] -> (logits
    [B, 1, V], caches).  The caches, stacked over layers as
    ``init_caches`` makes them, are updated in place and returned in the
    same dict: the reference's functional update, which XLA makes in
    place under jit, without copying every cache each step."""
    check_family(cfg)
    x = model.embed[token.long()]
    for li, layer in enumerate(model.layers):
        x = _decode_block(cfg, x, layer, caches, li, cache_len)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return L.matmul(x, lm_head(cfg, model)), caches
