"""Model building blocks of every family: norms, RoPE, GQA attention
(prefill, dense-cache decode and cross-attention), the MLP, the top-k MoE
and Mamba-1.

Parameters live in ``nn.Module``s that keep the reference's names (``wq wk
wv wo bq bk bv q_norm k_norm``, ``w_gate w_up w_down``, ``wi wo``,
``in_proj conv_w conv_b x_proj dt_proj dt_bias A_log D out_proj``) and its
``[in, out]`` layout, so ``x @ w`` reads as it does there; the functions
take the module the way the reference's take a parameter dict.
Parameters are bf16 (``DTYPE``) and drawn from a ``torch.Generator`` on
the given device, except Mamba's ``A_log`` and ``D`` and the MoE
``router``, which are fp32 as in the reference.

Where the reference mixes dtypes, JAX promotes (fp32 @ bf16 -> fp32);
``torch.matmul`` refuses mixed operands, so ``matmul`` casts both to
``torch.promote_types`` first.  Elementwise ops promote alike in both.

The prefill runs attention (causal, the encoder's non-causal and
cross-attention) through ``flash_attention`` and the scan through
``selective_scan_fused``: their kernels for CUDA tensors, their plain
versions for CPU tensors; both are autograd ``Function``s whose backward
recomputes through a plain version, so training takes the same path.
Decode's self-attention and scan (one token against dense caches) stay
plain tensor ops, as in the reference; its cross-attention is the same
``cross_attention`` as the prefill's, one query against the encoder's
K/V.  The MoE's expert products are plain batched products, as the
reference leaves them to XLA.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..kernels.flash_attention import ops as flash_ops
from ..kernels.selective_scan import ops as scan_ops

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


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) with sigmoid as 1 / (1 + exp(-x)), each op rounded
    in x's dtype: ``jax.nn.silu`` as XLA expands it, bit for bit in bf16
    (``F.silu`` rounds once and differs in the last bit of a third of
    bf16 values)."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation, as JAX writes it:
    x * 0.5 (1 + tanh(c (x + k x^3))) with c = sqrt(2 / pi) and k =
    0.044715 rounded to x's dtype and each op rounded in it, bit for bit
    in bf16 (``F.gelu(approximate="tanh")`` rounds once and differs in
    the last bit of over two fifths of bf16 values)."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1 + torch.tanh(c * (x + k * (x * x * x)))))


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
    """GQA projections (optional QKV bias and qk-norm); a cross-attention
    block (``cross``) has no QKV bias, as in the reference."""

    def __init__(self, cfg: ModelConfig,
                 gen: Optional[torch.Generator] = None, device=None,
                 cross: bool = False):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim_
        h, kv = cfg.num_heads, cfg.num_kv_heads
        self.wq = _dense_init(gen, (d, h * hd), device)
        self.wk = _dense_init(gen, (d, kv * hd), device)
        self.wv = _dense_init(gen, (d, kv * hd), device)
        self.wo = _dense_init(gen, (h * hd, d), device)
        if cfg.qkv_bias and not cross:
            self.bq = _zeros((h * hd,), device)
            self.bk = _zeros((kv * hd,), device)
            self.bv = _zeros((kv * hd,), device)
        if cfg.qk_norm:
            self.q_norm = _ones((hd,), device)
            self.k_norm = _ones((hd,), device)


def init_attention(cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                   device=None, cross: bool = False) -> Attention:
    return Attention(cfg, gen, device, cross)


def _project_qkv(p: Attention, cfg: ModelConfig, xq: torch.Tensor,
                 xkv: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q = matmul(xq, p.wq)
    k = matmul(xkv, p.wk)
    v = matmul(xkv, p.wv)
    if hasattr(p, "bq"):
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
        return matmul(gelu(matmul(x, p.wi)), p.wo)
    return matmul(silu(matmul(x, p.w_gate)) * matmul(x, p.w_up),
                  p.w_down)


class MoE(nn.Module):
    """Top-k MoE parameters: ``router`` [d, E] fp32 (drawn as DTYPE and
    widened, as the reference's), the experts' ``we_gate``/``we_up``
    [E, d, f] and ``we_down`` [E, f, d]."""

    def __init__(self, cfg: ModelConfig,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        self.router = nn.Parameter(
            _dense_init(gen, (d, e), device).data.float())
        self.we_gate = _dense_init(gen, (e, d, f), device, scale_axis=1)
        self.we_up = _dense_init(gen, (e, d, f), device, scale_axis=1)
        self.we_down = _dense_init(gen, (e, f, d), device, scale_axis=1)


def init_moe(cfg: ModelConfig, gen: Optional[torch.Generator] = None,
             device=None) -> MoE:
    return MoE(cfg, gen, device)


def moe_capacity(cfg: ModelConfig, s: int) -> int:
    """Slots an expert has a batch row of ``s`` tokens: S k / E times the
    capacity factor, at least 1."""
    return max(int(cfg.capacity_factor * s * cfg.top_k / cfg.num_experts), 1)


def moe_route(p: MoE, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights fp32 [B, S, k], experts int64 [B, S, k]): the top k of the
    softmax of the fp32 router product (largest first), renormalised.

    Equal gates go to the lower expert first, as ``jax.lax.top_k`` picks
    them: a stable descending sort cut to k (``torch.topk`` leaves the
    order of ties unspecified)."""
    gates = torch.softmax(matmul(x.float(), p.router), dim=-1)
    top_w, top_e = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :cfg.top_k], top_e[..., :cfg.top_k]
    return top_w / torch.sum(top_w, dim=-1, keepdim=True), top_e


def moe_slots(top_e: torch.Tensor, num_experts: int, cap: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot, kept) [B, S * k] of each (token, k) pair of a row in its
    expert's buffer: its rank among the row's pairs that chose that
    expert, in the flattened (token, k) order; a pair at or past ``cap``
    is dropped.  The one-hot is laid out [B, E, S * k], so the running
    count is a scan along the innermost dim (over the reference's
    [S * k, E] layout, PyTorch's outer-dim scan took ~6 ms a call at
    OLMoE-1B-7B's prefill on an NVIDIA H100 80GB HBM3 at 700 W, 40% of
    the prefill's device time)."""
    flat_e = top_e.reshape(top_e.shape[0], -1)
    experts = torch.arange(num_experts, device=top_e.device)
    onehot = (flat_e[:, None, :] == experts[None, :, None]).to(torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=2, dtype=torch.int32) - onehot
    pos = torch.gather(pos_in_e, 1, flat_e[:, None, :])[:, 0].long()
    return pos, pos < cap


def moe(p: MoE, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Top-k MoE with dispatch into per-expert buffers of ``moe_capacity``
    slots a batch row (overflow drops), the experts as three batched
    products over [B, E, C, d] and the combine in x's dtype: x [B, S, d]
    -> [B, S, d].

    The combine adds each token's k weighted expert outputs into a zero
    row one after another, in x's dtype, as the reference's scatter-add
    does: a sum of the k rounded once in fp32 differs in bf16's last bit.
    A dropped pair reads its expert's last slot and is zeroed, as there.
    Nothing in it waits for the card.
    """
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = moe_capacity(cfg, s)
    top_w, top_e = moe_route(p, cfg, x)
    pos, keep = moe_slots(top_e, e, cap)
    flat_e = top_e.reshape(b, s * k)
    rows = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    tok = torch.arange(s, device=x.device).repeat_interleave(k)
    # dropped pairs land in a spare slot past the last, cut off after
    buf = x.new_zeros((b, e, cap + 1, d)).index_put(
        (rows, flat_e, torch.where(keep, pos, cap)), x[:, tok])[:, :, :cap]
    h = silu(torch.einsum("becd,edf->becf", buf, p.we_gate)) \
        * torch.einsum("becd,edf->becf", buf, p.we_up)
    out_buf = torch.einsum("becf,efd->becd", h, p.we_down)
    gathered = out_buf[rows, flat_e, torch.clamp(pos, max=cap - 1)]
    gathered = torch.where(keep[..., None], gathered,
                           gathered.new_zeros(()))
    contrib = (gathered * top_w.reshape(b, s * k, 1).to(gathered.dtype)
               ).reshape(b, s, k, d)
    out = gathered.new_zeros((b, s, d))
    for j in range(k):
        out = out + contrib[:, :, j]
    return out


# ======================================================================
# attention over a sequence (prefill) and against a dense cache (decode)
# ======================================================================
def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: Optional[int]) -> torch.Tensor:
    """``flash_attention`` on [B, S, heads, D] tensors -> [B, Sq, H * D]
    (the kernel on the card, its plain version on the CPU; both keep the
    softmax weights in fp32 for the product with v)."""
    b, sq = q.shape[:2]
    heads = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
    out = flash_ops.flash_attention(*heads, causal=causal, window=window)
    return out.transpose(1, 2).reshape(b, sq, -1)


def attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, window: Optional[int] = None,
              causal: bool = True) -> torch.Tensor:
    """Self-attention over a prefill sequence through ``flash_attention``:
    causal in a decoder (``window`` the layer's sliding window or None for
    a full-attention layer; the reference encodes full attention as a
    window of 2**30), bidirectional in the encoder (``causal=False``, RoPE
    all the same, as the reference's encoder applies it)."""
    q, k, v = _project_qkv(p, cfg, x, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return matmul(_flash(q, k, v, causal, window), p.wo)


def cross_attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                    enc_kv: Tuple[torch.Tensor, torch.Tensor]
                    ) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V: x [B, S,
    d], enc_kv ([B, Skv, KV, D], same) -> [B, S, d].  q from x (qk-norm
    on q only, no RoPE), non-causal ``flash_attention``; K/V are cast to
    the promoted dtype of theirs and q's (the kernel takes one dtype)."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim_
    q = matmul(x, p.wq).reshape(b, s, h, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
    k, v = enc_kv
    dt = torch.promote_types(q.dtype, k.dtype)
    out = _flash(q.to(dt), k.to(dt), v.to(dt), False, None)
    return matmul(out, p.wo)


def attention_decode(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a dense KV cache.

    x: [B, 1, d]; k_cache/v_cache: [B, S, KV, D]; cache_len: [B] int, the
    new token's position (it goes to slot ``cache_len % S``).  Returns
    (out [B, 1, d], k_cache, v_cache): the given caches with the new
    token's k/v written in place, where the reference's functional update
    makes new ones (the serve step owns its caches).

    The mask is the reference's: slots up to ``min(cache_len, S - 1)``,
    and of those only the ones a ring buffer of S slots still holds
    (``slot > cache_len - S``).  The reference applies that test on every
    layer (its decode passes each layer a window array, never None) and
    has no other window test, so a sliding-window layer whose cache holds
    ``max_len`` slots (Hymba's, which has full-attention layers too)
    attends to the whole context in decode while ``forward`` masks it to
    the window.
    """
    b = x.shape[0]
    s_max = k_cache.shape[1]
    q, k, v = _project_qkv(p, cfg, x, x)
    pos = cache_len[:, None]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    slot = (cache_len % s_max).long()
    bidx = torch.arange(b, device=x.device)
    k_cache[bidx, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, slot] = v[:, 0].to(v_cache.dtype)
    kpos = torch.arange(s_max, device=x.device)[None, :]
    valid = (kpos <= torch.clamp(pos, max=s_max - 1)) & (kpos > pos - s_max)
    g = cfg.num_heads // cfg.num_kv_heads
    kvh, hd = cfg.num_kv_heads, cfg.head_dim_
    qr = q.reshape(b, kvh, g, hd)
    scores = torch.einsum("bhgd,bkhd->bhgk", qr.float(),
                          k_cache.to(q.dtype).float()) / math.sqrt(hd)
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", probs.to(q.dtype),
                       v_cache.to(q.dtype))
    out = out.reshape(b, 1, cfg.num_heads * hd)
    return matmul(out, p.wo), k_cache, v_cache


# ======================================================================
# Mamba-1 (selective state space)
# ======================================================================
class Mamba(nn.Module):
    """Mamba-1 parameters: ``A_log`` [di, N] = log(1..N) on every channel
    and ``D`` [di] = 1, both fp32; the rest DTYPE."""

    def __init__(self, cfg: ModelConfig,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        d, di = cfg.d_model, cfg.d_inner_
        n, rk, kc = cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
        self.in_proj = _dense_init(gen, (d, 2 * di), device)
        self.conv_w = _dense_init(gen, (kc, di), device)
        self.conv_b = _zeros((di,), device)
        self.x_proj = _dense_init(gen, (di, rk + 2 * n), device)
        self.dt_proj = _dense_init(gen, (rk, di), device)
        self.dt_bias = _zeros((di,), device)
        a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
        self.A_log = nn.Parameter(torch.log(a)[None, :].repeat(di, 1))
        self.D = nn.Parameter(torch.ones((di,), dtype=torch.float32,
                                         device=device))
        self.out_proj = _dense_init(gen, (di, d), device)


def init_mamba(cfg: ModelConfig, gen: Optional[torch.Generator] = None,
               device=None) -> Mamba:
    return Mamba(cfg, gen, device)


def _ssm_inputs(p: Mamba, cfg: ModelConfig, xs: torch.Tensor):
    """(dt fp32, B, C) from the conv output: ``x_proj``, its split and
    softplus in fp32.  The reference casts ``dt_in @ dt_proj`` to fp32,
    and XLA folds that cast into the product, so its dt is the product of
    the operands accumulated in fp32 and never rounded to their dtype;
    the port computes it so.  ``F.softplus`` returns x itself above its
    threshold of 20, where ``jax.nn.softplus`` adds log1p(exp(-x)) <
    2.1e-9, below fp32's resolution there."""
    n, rk = cfg.ssm_state, cfg.dt_rank
    dt_in, b_in, c_in = torch.split(matmul(xs, p.x_proj), [rk, n, n],
                                    dim=-1)
    dt = F.softplus(dt_in.float() @ p.dt_proj.float() + p.dt_bias)
    return dt, b_in, c_in


def mamba(p: Mamba, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Mamba-1 block over a prefill sequence: x [B, T, d] -> [B, T, d].
    The scan is the fused selective scan (kernel on the card), which never
    forms the [B, T, di, N] bx; any T."""
    t, kc = x.shape[1], cfg.ssm_conv
    xs, z = torch.chunk(matmul(x, p.in_proj), 2, dim=-1)
    # causal depthwise conv as a sum of shifted products
    xpad = F.pad(xs, (0, 0, kc - 1, 0))
    conv = xpad[:, 0:t] * p.conv_w[0]
    for i in range(1, kc):
        conv = conv + xpad[:, i:i + t] * p.conv_w[i]
    xs = silu(conv + p.conv_b)
    dt, b_in, c_in = _ssm_inputs(p, cfg, xs)
    # A in A_log's dtype, then widened: bf16 after an optimizer step, as
    # the reference's bf16 -exp(A_log) promotes against fp32 dt
    y = scan_ops.selective_scan_fused(
        dt, xs.float().contiguous(), b_in.float().contiguous(),
        c_in.float().contiguous(), (-torch.exp(p.A_log)).float())
    y = y + xs.float() * p.D
    return matmul(y.to(x.dtype) * silu(z), p.out_proj)


def mamba_decode(p: Mamba, cfg: ModelConfig, x: torch.Tensor,
                 conv_state: torch.Tensor, ssm_state: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token Mamba step: x [B, 1, d]; conv_state [B, kc - 1, di];
    ssm_state [B, di, N] fp32 -> (y [B, 1, d], conv_state, ssm_state).
    The new conv state has the promoted dtype of the old one and x's
    projection, as in the reference (a bf16 cache turns fp32 under fp32
    weights)."""
    xs, z = torch.chunk(matmul(x[:, 0], p.in_proj), 2, dim=-1)
    wdt = torch.promote_types(conv_state.dtype, xs.dtype)
    window = torch.cat([conv_state.to(wdt), xs[:, None].to(wdt)], dim=1)
    cdt = torch.promote_types(wdt, p.conv_w.dtype)
    xs = torch.einsum("bkd,kd->bd", window.to(cdt), p.conv_w.to(cdt))
    xs = silu(xs + p.conv_b)
    dt, b_in, c_in = _ssm_inputs(p, cfg, xs)
    decay = torch.exp(dt[..., None] * -torch.exp(p.A_log))
    bx = dt[..., None] * b_in[:, None, :].float() * xs[..., None].float()
    ssm_state = ssm_state * decay + bx
    y = torch.einsum("bdn,bn->bd", ssm_state, c_in.float())
    y = y + xs.float() * p.D
    y = y.to(x.dtype) * silu(z)
    return matmul(y, p.out_proj)[:, None], window[:, 1:], ssm_state
