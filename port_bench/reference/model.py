"""Plain float32 forward of the benchmark's architectures: Mamba-1 (the
``ssm`` family) and Hymba-style hybrid layers (attention and Mamba heads
side by side over the same input, then a SwiGLU MLP).

Weights are the benchmark's dict of named tensors (``weights.draw``),
upcast to float32 where used.  A layer of the ``ssm`` family is
``x + mamba(rms_norm(x))``; a hybrid layer is ``x + attention(rms_norm_a
(x)) + mamba(rms_norm_s(x))`` and then ``x + mlp(rms_norm_m(x))``.
Attention: GQA with rotary positions (rotate-half, theta from the
configuration), causal, a key visible when ``kp > qp - window`` on a
windowed layer, softmax in float32.  Mamba-1: in_proj into x and z, a
causal depthwise convolution of ``ssm_conv`` taps with bias, SiLU, x_proj
into dt, B and C, dt = softplus(dt @ dt_proj + dt_bias), A = -exp(A_log),
the selective scan h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t
+ D x_t, then (y * silu(z)) @ out_proj.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

CHUNK = 64              # steps of the scan combined at once


# ----------------------------------------------------------------------
# matrix products, in float32 or (the control) float8
# ----------------------------------------------------------------------
def _q8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to a float8 type with one scale for the tensor (its
    largest magnitude onto the type's largest finite value), back in
    float32."""
    top = torch.finfo(dtype).max
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _MatmulFp8(torch.autograd.Function):
    """a @ b with both operands rounded to e4m3; the backward's products
    with the gradient rounded to e5m2 and the saved operands to e4m3."""

    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = _q8(a, torch.float8_e4m3fn), _q8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = _q8(g, torch.float8_e5m2)
        return g8 @ b8.transpose(-1, -2), a8.transpose(-1, -2) @ g8


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in float32, or with float8 operands for the control (a
    weight [in, out] against rows of any leading shape, or two tensors of
    the same leading shape)."""
    if precision == "fp32":
        return a @ b
    if precision != "fp8":
        raise ValueError(f"no reference precision {precision!r}")
    if b.dim() == 2:
        rows = a.reshape(-1, a.shape[-1])
        return _MatmulFp8.apply(rows, b).reshape(*a.shape[:-1], b.shape[1])
    return _MatmulFp8.apply(a, b)


def f32(w: torch.Tensor) -> torch.Tensor:
    return w.to(torch.float32)


# ----------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------
def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * f32(w)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, T, heads, D] at positions 0..T-1, rotate-half form."""
    t, d = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(w: Dict, pre: str, cfg: Dict, x: torch.Tensor,
              window: Optional[int], precision: str) -> torch.Tensor:
    b, t, _ = x.shape
    h, kvh, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q = mm(x, f32(w[pre + "wq"]), precision).reshape(b, t, h, hd)
    k = mm(x, f32(w[pre + "wk"]), precision).reshape(b, t, kvh, hd)
    v = mm(x, f32(w[pre + "wv"]), precision).reshape(b, t, kvh, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    g = h // kvh
    q = q.transpose(1, 2)                                   # [B, H, T, D]
    k = k.transpose(1, 2).repeat_interleave(g, dim=1)
    v = v.transpose(1, 2).repeat_interleave(g, dim=1)
    scores = mm(q, k.transpose(-1, -2), precision) / math.sqrt(hd)
    qp = torch.arange(t, device=x.device)[:, None]
    kp = torch.arange(t, device=x.device)[None, :]
    visible = kp <= qp
    if window is not None:
        visible = visible & (kp > qp - window)
    scores = scores.masked_fill(~visible, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = mm(probs, v, precision).transpose(1, 2).reshape(b, t, h * hd)
    return mm(out, f32(w[pre + "wo"]), precision)


def mlp(w: Dict, pre: str, x: torch.Tensor, precision: str) -> torch.Tensor:
    gate = mm(x, f32(w[pre + "w_gate"]), precision)
    up = mm(x, f32(w[pre + "w_up"]), precision)
    return mm(silu(gate) * up, f32(w[pre + "w_down"]), precision)


def _scan_chunk(dt, x, bm, c, a, h0):
    """One chunk of the selective scan: dt, x [B, L, di]; bm, c [B, L,
    N]; a [di, N]; h0 [B, di, N] -> (y [B, L, di], h at the chunk's end).
    The recurrence h_t = da_t h_{t-1} + u_t is combined over the chunk in
    log2(L) doubling steps: (da, u) at t absorbs (da, u) at t - s."""
    da = torch.exp(dt[..., None] * a)                       # [B, L, di, N]
    u = (dt * x)[..., None] * bm[:, :, None, :]
    s, n = 1, dt.shape[1]
    while s < n:
        u = torch.cat([u[:, :s], da[:, s:] * u[:, :-s] + u[:, s:]], dim=1)
        da = torch.cat([da[:, :s], da[:, s:] * da[:, :-s]], dim=1)
        s *= 2
    h = da * h0[:, None] + u
    return torch.einsum("bldn,bln->bld", h, c), h[:, -1]


def scan(dt, x, bm, c, a, h0=None):
    """The selective scan over the whole sequence, a chunk at a time
    (each under checkpointing when a gradient is wanted) -> (y [B, T,
    di], the last state [B, di, N])."""
    b, t, di = dt.shape
    h = torch.zeros((b, di, a.shape[1]), dtype=torch.float32,
                    device=dt.device) if h0 is None else h0
    ys = []
    grad = torch.is_grad_enabled()
    for i in range(0, t, CHUNK):
        args = (dt[:, i:i + CHUNK], x[:, i:i + CHUNK], bm[:, i:i + CHUNK],
                c[:, i:i + CHUNK], a, h)
        if grad:
            y, h = checkpoint(_scan_chunk, *args, use_reentrant=False)
        else:
            y, h = _scan_chunk(*args)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def mamba(w: Dict, pre: str, cfg: Dict, x: torch.Tensor, precision: str
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (out [B, T, d], the scan's last state [B, di, N], the last
    ssm_conv - 1 convolution inputs [B, kc - 1, di])."""
    t, kc, n, rk = x.shape[1], cfg["ssm_conv"], cfg["ssm_state"], \
        cfg["dt_rank"]
    xs, z = torch.chunk(mm(x, f32(w[pre + "in_proj"]), precision), 2,
                        dim=-1)
    conv_state = xs[:, -(kc - 1):]
    xpad = F.pad(xs, (0, 0, kc - 1, 0))
    conv_w = f32(w[pre + "conv_w"])
    conv = sum(xpad[:, i:i + t] * conv_w[i] for i in range(kc))
    xs = silu(conv + f32(w[pre + "conv_b"]))
    dt_in, bm, c = torch.split(mm(xs, f32(w[pre + "x_proj"]), precision),
                               [rk, n, n], dim=-1)
    dt = F.softplus(mm(dt_in, f32(w[pre + "dt_proj"]), precision)
                    + f32(w[pre + "dt_bias"]))
    a = -torch.exp(f32(w[pre + "A_log"]))
    y, h = scan(dt, xs, bm, c, a)
    y = y + xs * f32(w[pre + "D"])
    return mm(y * silu(z), f32(w[pre + "out_proj"]), precision), h, \
        conv_state


def layer_windows(cfg: Dict) -> List[Optional[int]]:
    full = {i % cfg["num_layers"] for i in cfg["full_attn_layers"]}
    win = cfg["sliding_window"]
    return [None if (i in full or not win) else win
            for i in range(cfg["num_layers"])]


def block(w: Dict, li: int, cfg: Dict, x: torch.Tensor,
          window: Optional[int], precision: str):
    """Layer ``li`` -> (x, its scan's last state, its conv inputs)."""
    pre, eps = f"layers.{li}.", cfg["norm_eps"]
    ssm_out, h, conv = mamba(w, pre + "ssm.", cfg,
                             rms_norm(x, w[pre + "ssm_norm"], eps),
                             precision)
    if cfg["family"] == "ssm":
        x = x + ssm_out
    else:
        x = x + attention(w, pre + "attn.", cfg,
                          rms_norm(x, w[pre + "attn_norm"], eps), window,
                          precision) + ssm_out
    if cfg["d_ff"] > 0:
        x = x + mlp(w, pre + "mlp.", rms_norm(x, w[pre + "mlp_norm"], eps),
                    precision)
    return x, h, conv


def _block_x(w, li, cfg, x, window, precision):
    return block(w, li, cfg, x, window, precision)[0]


def hidden(w: Dict, cfg: Dict, tokens: torch.Tensor, precision: str = "fp32",
           remat: bool = False, states: Optional[list] = None
           ) -> torch.Tensor:
    """tokens [B, T] -> the final-normed hidden states [B, T, d].  With
    ``remat`` each layer runs under checkpointing; ``states``, a list,
    receives each layer's (scan state, conv inputs)."""
    if cfg["family"] not in ("ssm", "hybrid"):
        raise ValueError(f"no reference for family {cfg['family']!r}")
    x = f32(w["embed"])[tokens.long()]
    for li, window in enumerate(layer_windows(cfg)):
        if remat:
            x = checkpoint(_block_x, w, li, cfg, x, window, precision,
                           use_reentrant=False)
        else:
            x, h, conv = block(w, li, cfg, x, window, precision)
            if states is not None:
                states.append((h, conv))
    return rms_norm(x, w["final_norm"], cfg["norm_eps"])


def logits(w: Dict, cfg: Dict, h: torch.Tensor, precision: str = "fp32"
           ) -> torch.Tensor:
    return mm(h, f32(w["lm_head"]), precision)


def loss(w: Dict, cfg: Dict, tokens: torch.Tensor, targets: torch.Tensor,
         precision: str = "fp32") -> torch.Tensor:
    """Mean next-token cross entropy over every position."""
    h = hidden(w, cfg, tokens, precision, remat=True)
    out = logits(w, cfg, h, precision)
    return F.cross_entropy(out.reshape(-1, out.shape[-1]),
                           targets.reshape(-1).long())
