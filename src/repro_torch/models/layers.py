"""Model building blocks of the dense decoder: norms, RoPE, GQA projections
and the MLP.

Attention and MLP parameters live in ``nn.Module``s that keep the
reference's names (``wq wk wv wo bq bk bv q_norm k_norm``, ``w_gate w_up
w_down``, ``wi wo``) and its ``[in, out]`` layout, so ``x @ w`` reads as
it does there; the functions take the module the way the reference's take
a parameter dict.  Parameters are bf16 (``DTYPE``) and drawn from a
``torch.Generator`` on the given device.

Where the reference mixes dtypes, JAX promotes (fp32 @ bf16 -> fp32);
``torch.matmul`` refuses mixed operands, so ``matmul`` casts both to
``torch.promote_types`` first.  MoE, Mamba, cross-attention and the dense
``sdpa`` come with later slices.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig

DTYPE = torch.bfloat16


# ======================================================================
# initialisation helpers
# ======================================================================
def _dense_init(gen: Optional[torch.Generator], shape, device=None,
                scale_axis: int = 0) -> nn.Parameter:
    """Normal(0, 1 / fan_in) drawn in fp32 from ``gen``, stored as DTYPE;
    with no generator the storage is left uninitialised (to be loaded)."""
    if gen is None:
        return nn.Parameter(torch.empty(shape, dtype=DTYPE, device=device))
    fan_in = shape[scale_axis] if shape else 1
    std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device) * std
    return nn.Parameter(w.to(DTYPE))


def _zeros(shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=DTYPE, device=device))


def _ones(shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.ones(shape, dtype=DTYPE, device=device))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two, as JAX computes it."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


# ======================================================================
# norms / rope
# ======================================================================
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] int."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # [D/2]
    ang = positions.float()[..., None] * freqs              # [B, S, D/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ======================================================================
# attention
# ======================================================================
class Attention(nn.Module):
    """GQA projections (optional QKV bias and qk-norm)."""

    def __init__(self, cfg: ModelConfig,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim_
        h, kv = cfg.num_heads, cfg.num_kv_heads
        self.wq = _dense_init(gen, (d, h * hd), device)
        self.wk = _dense_init(gen, (d, kv * hd), device)
        self.wv = _dense_init(gen, (d, kv * hd), device)
        self.wo = _dense_init(gen, (h * hd, d), device)
        if cfg.qkv_bias:
            self.bq = _zeros((h * hd,), device)
            self.bk = _zeros((kv * hd,), device)
            self.bv = _zeros((kv * hd,), device)
        if cfg.qk_norm:
            self.q_norm = _ones((hd,), device)
            self.k_norm = _ones((hd,), device)


def init_attention(cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                   device=None) -> Attention:
    return Attention(cfg, gen, device)


def _project_qkv(p: Attention, cfg: ModelConfig, xq: torch.Tensor,
                 xkv: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q = matmul(xq, p.wq)
    k = matmul(xkv, p.wk)
    v = matmul(xkv, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(*xq.shape[:-1], h, hd)
    k = k.reshape(*xkv.shape[:-1], kv, hd)
    v = v.reshape(*xkv.shape[:-1], kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return q, k, v


# ======================================================================
# MLP
# ======================================================================
class MLP(nn.Module):
    """SwiGLU (``w_gate w_up w_down``) or GELU (``wi wo``)."""

    def __init__(self, cfg: ModelConfig,
                 gen: Optional[torch.Generator] = None, device=None,
                 d_ff: Optional[int] = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        if cfg.act == "gelu":
            self.wi = _dense_init(gen, (d, f), device)
            self.wo = _dense_init(gen, (f, d), device)
        else:
            self.w_gate = _dense_init(gen, (d, f), device)
            self.w_up = _dense_init(gen, (d, f), device)
            self.w_down = _dense_init(gen, (f, d), device)


def init_mlp(cfg: ModelConfig, gen: Optional[torch.Generator] = None,
             device=None, d_ff: Optional[int] = None) -> MLP:
    return MLP(cfg, gen, device, d_ff)


def mlp(p: MLP, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        return matmul(F.gelu(matmul(x, p.wi), approximate="tanh"), p.wo)
    return matmul(F.silu(matmul(x, p.w_gate)) * matmul(x, p.w_up),
                  p.w_down)
