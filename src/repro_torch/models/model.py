"""Model assembly for every family: dense, moe, ssm, hybrid, encdec and
vlm.

``Model`` holds the embedding, one ``DecoderLayer`` per layer in a
``ModuleList`` (the reference stacks them on a leading axis for
``lax.scan``; here layer ``li`` is ``model.layers[li]`` and the layers run
in a Python loop), the final norm, the untied LM head and, for encdec,
the ``encoder`` (its ``layers`` and ``final_norm``).  It is initialised
from a ``torch.Generator`` on the given device, in bf16 like the
reference, with Mamba's ``A_log`` and ``D`` and the MoE router in fp32.

Entry points, as in the reference:
  forward(cfg, model, batch, remat, constraint) -> logits (train, prefill)
  decode_step(cfg, model, token, len, caches)  -> logits, caches
  init_caches(cfg, batch, max_len)             -> dense decode caches
  param_shapes(cfg)                            -> the model on ``meta``
  _encode(cfg, model, frames), encoder_kv(...) -> encdec's cross K/V
A batch holds ``tokens``, and ``frames`` [B, encoder_seq, d] for encdec
(the stubbed audio frontend's output) or ``vision_embeds`` [B,
vision_prefix, d] for vlm (the stubbed vision frontend's, written over
the first positions).  Decode takes tokens only, as the reference's: an
encdec model's ``cross_k``/``cross_v`` caches are filled by the caller
from ``encoder_kv``.  The serving engine (``serving/engine.py``) runs the
dense layers itself against its paged KV pool.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from . import layers as L

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; the "
                         f"port has {', '.join(FAMILIES)}")


class DecoderLayer(nn.Module):
    """Norms and blocks of one layer, named as the reference's: ``attn``
    except in the ssm family, ``cross_norm`` and ``cross_attn`` in an
    encdec decoder (``cross``), ``moe`` for a MoE model or else ``mlp``
    when d_ff > 0, ``ssm_norm`` and ``ssm`` in the ssm and hybrid
    families.  The encoder's layers are of this class too."""

    def __init__(self, cfg: ModelConfig,
                 gen: Optional[torch.Generator] = None, device=None,
                 cross: bool = False):
        super().__init__()
        self.attn_norm = L._ones((cfg.d_model,), device)
        self.mlp_norm = L._ones((cfg.d_model,), device)
        if cfg.family != "ssm":
            self.attn = L.init_attention(cfg, gen, device)
        if cross:
            self.cross_norm = L._ones((cfg.d_model,), device)
            self.cross_attn = L.init_attention(cfg, gen, device, cross=True)
        if cfg.is_moe:
            self.moe = L.init_moe(cfg, gen, device)
        elif cfg.d_ff > 0:
            self.mlp = L.init_mlp(cfg, gen, device)
        if cfg.has_ssm:
            self.ssm_norm = L._ones((cfg.d_model,), device)
            self.ssm = L.init_mamba(cfg, gen, device)


class Encoder(nn.Module):
    """An encdec model's encoder: ``layers`` and ``final_norm``."""

    def __init__(self, cfg: ModelConfig,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(cfg, gen, device)
                                    for _ in range(cfg.encoder_layers))
        self.final_norm = L._ones((cfg.d_model,), device)


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
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, gen, device, cross=cfg.encoder_layers > 0)
            for _ in range(cfg.num_layers))
        self.lm_head = None if cfg.tie_embeddings else L._dense_init(
            gen, (cfg.d_model, cfg.vocab_size), device)
        self.encoder = Encoder(cfg, gen, device) if cfg.encoder_layers \
            else None


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda",
               dtype: torch.dtype = L.DTYPE) -> Model:
    """A model with random weights drawn on ``device`` from a generator
    seeded with ``seed``.  The parameters the reference draws in bf16 are
    cast to ``dtype``; the fp32 ones (Mamba's ``A_log`` and ``D``, the
    MoE router) stay fp32."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = Model(cfg, generator=gen, device=device)
    for p in model.parameters():
        if p.dtype == L.DTYPE:
            p.data = p.data.to(dtype)
    return model


def param_shapes(cfg: ModelConfig) -> Model:
    """A model's structure, shapes and dtypes on the meta device, without
    allocation (for the dry run and ``launch.specs``): bf16 parameters,
    fp32 ``A_log``, ``D`` and router."""
    return Model(cfg, device="meta")


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
    """batch["tokens"]: int [B, S] -> [B, S, d]; a vlm's first positions
    are ``batch["vision_embeds"]`` [B, P, d] cast to the embedding's
    dtype."""
    x = model.embed[batch["tokens"].long()]
    if cfg.vision_prefix:
        ve = batch["vision_embeds"]
        x = torch.cat([ve.to(x.dtype), x[:, ve.shape[1]:]], dim=1)
    return x


def _block(cfg: ModelConfig, x: torch.Tensor, layer: DecoderLayer,
           positions: torch.Tensor, window: Optional[int],
           enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
           constraint=None) -> torch.Tensor:
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
    if enc_kv is not None:
        h = L.rms_norm(x, layer.cross_norm, eps)
        x = x + L.cross_attention(layer.cross_attn, cfg, h, enc_kv)
    return _ffn(cfg, x, layer, constraint)


def _ffn(cfg: ModelConfig, x: torch.Tensor, layer: DecoderLayer,
         constraint=None) -> torch.Tensor:
    """The layer's MoE or MLP on its normed input, added to x."""
    if cfg.is_moe:
        return x + _moe_dispatch(cfg, layer.moe, L.rms_norm(
            x, layer.mlp_norm, cfg.norm_eps), constraint)
    if cfg.d_ff > 0:
        return x + L.mlp(layer.mlp, cfg, L.rms_norm(x, layer.mlp_norm,
                                                    cfg.norm_eps))
    return x


def sharded_moe(cfg: ModelConfig, constraint, b: int, s: int) -> bool:
    """Whether ``_moe_dispatch`` takes the sharded MoE for a global batch
    of ``b`` rows of ``s`` tokens: ``constraint`` carries a mesh with
    sequence-sharded activations and the shapes divide it, as the
    reference picks it."""
    mesh = getattr(constraint, "mesh", None)
    if not cfg.is_moe or mesh is None \
            or not getattr(constraint, "seq_shard", False):
        return False
    from ..sharding import _axis_size
    ep = _axis_size(mesh, "model")
    return s % ep == 0 and b % _axis_size(mesh, constraint.dp) == 0 \
        and (cfg.num_experts % ep == 0 or cfg.d_ff % ep == 0)


def _moe_dispatch(cfg: ModelConfig, p: L.MoE, h: torch.Tensor,
                  constraint) -> torch.Tensor:
    """The sharded MoE (``moe_sharded.moe_shard_map``) where
    ``sharded_moe`` says so; else ``layers.moe``.  A local ``h`` enters
    as a DTensor with no exchange: the whole tensor on every rank (the
    model around it runs replicated), or this rank's rows under
    ``constraint.local`` (a step on DTensor state); it leaves the same
    way, through ``full_tensor`` or back to those rows."""
    local = getattr(constraint, "local", None)
    if getattr(constraint, "mesh", None) is not None:
        from torch.distributed.tensor import DTensor, Replicate
        mesh = constraint.mesh
        hd = DTensor.from_local(h, mesh, local or [Replicate()] * mesh.ndim,
                                run_check=False)
        if sharded_moe(cfg, constraint, hd.shape[0], hd.shape[1]):
            from .moe_sharded import moe_shard_map
            y = moe_shard_map(p, cfg, hd, mesh, constraint.dp)
            return y.full_tensor() if local is None \
                else y.redistribute(mesh, local).to_local()
    return L.moe(p, cfg, h, constraint=constraint)


def _layer(fn, remat: bool, *args) -> torch.Tensor:
    """``fn(*args)``, under ``torch.utils.checkpoint`` with ``remat``."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _encoder_block(cfg: ModelConfig, x: torch.Tensor, layer: DecoderLayer,
                   positions: torch.Tensor) -> torch.Tensor:
    h = L.rms_norm(x, layer.attn_norm, cfg.norm_eps)
    x = x + L.attention(layer.attn, cfg, h, positions, causal=False)
    return _ffn(cfg, x, layer)


def _encode(cfg: ModelConfig, model: Model, frames: torch.Tensor,
            remat: bool = False) -> torch.Tensor:
    """The encoder over frame embeddings [B, S, d] (the stubbed audio
    frontend's output, cast to the embedding's dtype): bidirectional
    self-attention with RoPE, as the reference's encoder applies it, then
    the MLP, a layer at a time, and the final norm -> [B, S, d].  The
    reference casts the frames to bf16, its parameters' dtype; with fp32
    parameters its scan refuses the carry that turns fp32, so it runs
    encdec in bf16 only, where the two casts agree."""
    enc = model.encoder
    b, s, _ = frames.shape
    positions = torch.arange(s, device=frames.device)[None].expand(b, s)
    x = frames.to(model.embed.dtype)
    remat = remat and torch.is_grad_enabled()
    for layer in enc.layers:
        x = _layer(_encoder_block, remat, cfg, x, layer, positions)
    return L.rms_norm(x, enc.final_norm, cfg.norm_eps)


def encoder_kv(cfg: ModelConfig, model: Model, enc_out: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each decoder layer's cross-attention K and V of the encoder's
    output [B, S, d]: two [L, B, S, KV, D] tensors (no bias, no
    qk-norm), as the decode caches hold them."""
    b, s, _ = enc_out.shape
    kv, hd = cfg.num_kv_heads, cfg.head_dim_
    ks, vs = [], []
    for layer in model.layers:
        ks.append(L.matmul(enc_out, layer.cross_attn.wk).reshape(b, s, kv,
                                                                 hd))
        vs.append(L.matmul(enc_out, layer.cross_attn.wv).reshape(b, s, kv,
                                                                 hd))
    return torch.stack(ks), torch.stack(vs)


def forward(cfg: ModelConfig, model: Model, batch: Dict,
            remat: bool = True, constraint=None,
            return_hidden: bool = False) -> torch.Tensor:
    """Training / prefill forward -> logits [B, S, V] (or the
    final-normed hidden states [B, S, d] when ``return_hidden``).  With
    ``remat`` and grad mode on, each layer runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
    scanned layer): only the layer inputs are kept, and the backward runs
    each layer's forward again, its kernels included.  An encdec model
    first encodes ``batch["frames"]``; its decoder layers attend to their
    cross K/V of it and have no window.  ``constraint``
    (``sharding.activation_constraint``) is applied to each layer's
    output and reaches the MoE (``_moe_dispatch``)."""
    check_family(cfg)
    x = embed_inputs(cfg, model, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    remat = remat and torch.is_grad_enabled()
    if cfg.encoder_layers:
        ek, ev = encoder_kv(cfg, model, _encode(cfg, model, batch["frames"],
                                                remat))
        kvs = [(ek[li], ev[li]) for li in range(cfg.num_layers)]
        windows = [None] * cfg.num_layers
    else:
        kvs, windows = [None] * cfg.num_layers, _windows(cfg)
    for layer, window, kv in zip(model.layers, windows, kvs):
        x = _layer(_block, remat, cfg, x, layer, positions, window, kv,
                   constraint)
        if constraint is not None:
            x = constraint(x)
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
    ``cross_k``/``cross_v`` [L, B, encoder_seq, KV, D] bf16 for encdec
    (zeros: the caller writes ``encoder_kv``'s there), whatever the
    weights' dtype, as in the reference."""
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
    if cfg.encoder_layers:
        caches["cross_k"] = torch.zeros(
            (nl, batch_size, cfg.encoder_seq, cfg.num_kv_heads,
             cfg.head_dim_), dtype=L.DTYPE, device=device)
        caches["cross_v"] = torch.zeros_like(caches["cross_k"])
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
    (attention writes the new token's k/v slot into the stacked cache).
    With ``cross_k`` in the caches, the token then attends to the
    encoder's K/V through ``cross_attention``."""
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
    if "cross_k" in caches:
        h = L.rms_norm(x, layer.cross_norm, eps)
        x = x + L.cross_attention(layer.cross_attn, cfg, h,
                                  (caches["cross_k"][li],
                                   caches["cross_v"][li]))
    return _ffn(cfg, x, layer)


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
