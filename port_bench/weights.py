"""The benchmark's weights: drawn on the device from the run's seed, in
the type they are served in (bfloat16; Mamba's ``A_log`` and ``D`` in
float32), with the port's parameter names and shapes.

The initialisation is Mamba's published one (the reference code's
``_init_weights`` and ``dt_proj`` set-up), carried to every matrix:
- matrices N(0, 1 / fan_in) (the embedding's fan is d_model), and the
  projections that end a residual branch (Mamba's ``out_proj``,
  attention's ``wo``, the MLP's ``w_down``) a further 1 / sqrt(layers);
- ``dt_bias`` the inverse softplus of a dt drawn log-uniform in [1e-3,
  1e-1], so that softplus(dt_in @ dt_proj + dt_bias) starts there;
- norms 1, the convolution's bias 0, ``A_log`` = log(1..N) on every
  channel, ``D`` = 1.
With these, a random 64-layer Mamba stays smooth enough that its bf16
logits differ from float32 arithmetic by a few percent; with every
matrix at 1 / fan_in and dt near softplus(0) they differed by as much as
the logits themselves, and no check could tell bf16 from float8.

Matrices are drawn in float32 by one ``torch.Generator`` in a few large
calls, each of at most ``CHUNK`` values, then scaled and rounded into one
bfloat16 buffer that every matrix is a view of.  The same seed and device
give the same values, so the reference draws them again instead of
keeping a copy.  ``load_program`` hands them to the port's ``Model``
without a second copy."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

DT_MIN, DT_MAX = 1e-3, 1e-1     # Mamba's range of dt at initialisation
CHUNK = 1 << 28         # values a call of the generator draws at most
Leaf = Tuple[str, Tuple[int, ...], str]     # name, shape, how it starts


def leaves(cfg: Dict) -> List[Leaf]:
    """Every parameter of the configuration, as the port names them."""
    d, v = cfg["d_model"], cfg["vocab_size"]
    out: List[Leaf] = [("embed", (v, d), "normal_embed"),
                       ("final_norm", (d,), "ones")]
    for li in range(cfg["num_layers"]):
        p = f"layers.{li}."
        out += [(p + "attn_norm", (d,), "ones"), (p + "mlp_norm", (d,), "ones")]
        if cfg["family"] != "ssm":
            h, kv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
            out += [(p + "attn.wq", (d, h * hd), "normal"),
                    (p + "attn.wk", (d, kv * hd), "normal"),
                    (p + "attn.wv", (d, kv * hd), "normal"),
                    (p + "attn.wo", (h * hd, d), "normal_out")]
        if cfg["d_ff"] > 0:
            f = cfg["d_ff"]
            out += [(p + "mlp.w_gate", (d, f), "normal"),
                    (p + "mlp.w_up", (d, f), "normal"),
                    (p + "mlp.w_down", (f, d), "normal_out")]
        if cfg["family"] in ("ssm", "hybrid"):
            di, n, rk = cfg["d_inner"], cfg["ssm_state"], cfg["dt_rank"]
            kc = cfg["ssm_conv"]
            s = p + "ssm."
            out += [(p + "ssm_norm", (d,), "ones"),
                    (s + "in_proj", (d, 2 * di), "normal"),
                    (s + "conv_w", (kc, di), "normal"),
                    (s + "conv_b", (di,), "zeros"),
                    (s + "x_proj", (di, rk + 2 * n), "normal"),
                    (s + "dt_proj", (rk, di), "normal"),
                    (s + "dt_bias", (di,), "dt_bias"),
                    (s + "A_log", (di, n), "a_log"),
                    (s + "D", (di,), "ones32"),
                    (s + "out_proj", (di, d), "normal_out")]
    if not cfg["tie_embeddings"]:
        out.append(("lm_head", (d, v), "normal"))
    return out


def _numel(shape) -> int:
    return math.prod(shape)


def draw(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> tensor on ``device``, drawn from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    spec = leaves(cfg)
    normal = [leaf for leaf in spec if leaf[2].startswith("normal")]
    flat = torch.empty(sum(_numel(s) for _, s, _ in normal),
                       dtype=torch.bfloat16, device=device)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    i = 0
    while i < len(normal):          # a call covers leaves up to CHUNK values
        group, n = [], 0
        while i < len(normal) and (not group
                                   or n + _numel(normal[i][1]) <= CHUNK):
            group.append(normal[i])
            n += _numel(normal[i][1])
            i += 1
        buf = torch.randn(n, generator=gen, dtype=torch.float32,
                          device=device)
        at = 0
        for name, shape, kind in group:
            k = _numel(shape)
            fan = shape[1] if kind == "normal_embed" else shape[0]
            std = 1.0 / math.sqrt(fan)
            if kind == "normal_out":
                std /= math.sqrt(cfg["num_layers"])
            dst = flat[off:off + k]
            dst.copy_(buf[at:at + k].mul_(std))
            out[name] = dst.view(shape)
            off += k
            at += k
        del buf
    for name, shape, kind in spec:
        if kind == "dt_bias":
            u = torch.rand(shape, generator=gen, dtype=torch.float32,
                           device=device)
            dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN))
                           + math.log(DT_MIN))
            out[name] = (dt + torch.log(-torch.expm1(-dt))).to(torch.bfloat16)
        elif kind == "ones":
            out[name] = torch.ones(shape, dtype=torch.bfloat16, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, dtype=torch.bfloat16,
                                    device=device)
        elif kind == "ones32":
            out[name] = torch.ones(shape, dtype=torch.float32, device=device)
        elif kind == "a_log":
            a = torch.arange(1, shape[1] + 1, dtype=torch.float32,
                             device=device)
            out[name] = torch.log(a)[None, :].repeat(shape[0], 1)
    return {name: out[name] for name, _, _ in spec}


def load_program(pcfg, weights: Dict[str, torch.Tensor], grad: bool):
    """The port's ``Model`` for the program configuration ``pcfg``, built
    on the meta device and given ``weights`` as its parameters (no copy).
    Raises if a name, shape or type differs from what the port builds."""
    from repro_torch.models import model as M
    model = M.Model(pcfg, generator=None, device="meta")
    have = dict(model.named_parameters())
    if set(have) != set(weights):
        raise ValueError("the port's parameters differ from the benchmark's: "
                         f"{sorted(set(have) ^ set(weights))[:8]}")
    for name, p in have.items():
        w = weights[name]
        if tuple(p.shape) != tuple(w.shape) or p.dtype != w.dtype:
            raise ValueError(f"{name}: the port builds {tuple(p.shape)} "
                             f"{p.dtype}, the benchmark {tuple(w.shape)} "
                             f"{w.dtype}")
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        mod._parameters[leaf] = torch.nn.Parameter(w, requires_grad=grad)
    return model
