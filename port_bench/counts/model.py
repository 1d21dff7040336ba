"""Model FLOPs of a step, from a configuration file's sizes (the
benchmark's own copy, not the program's): 2 flops a multiply-add of
every weight matrix a token passes through, and attention's own
products over each layer's visible keys.  A training step counts three
times the forward (forward, and the backward's two products), whatever
the program recomputes; an inference step counts what its output needs
(a prefill projects only each sequence's last position to the
vocabulary).  Elementwise work (norms, the scan's recurrence, the
optimizer) is not counted: this is the numerator of a model FLOPs
utilisation."""
from __future__ import annotations

from typing import Dict, List, Optional

from .kernels import FLASH_FWD_FLOPS, visible_keys


def layer_matmul_params(cfg: Dict) -> int:
    """Weights a token multiplies in one layer."""
    d, f = cfg["d_model"], cfg["d_ff"]
    n = 0
    if cfg["family"] != "ssm":
        hd, h, kv = cfg["head_dim"], cfg["num_heads"], cfg["num_kv_heads"]
        n += d * h * hd + 2 * d * kv * hd + h * hd * d
    if f > 0:
        n += 3 * d * f
    if cfg["family"] in ("ssm", "hybrid"):
        di, ns, rk = cfg["d_inner"], cfg["ssm_state"], cfg["dt_rank"]
        n += d * 2 * di + di * (rk + 2 * ns) + rk * di + di * d
    return n


def windows(cfg: Dict) -> List[Optional[int]]:
    """Each layer's attention window (None: full)."""
    full = {i % cfg["num_layers"] for i in cfg["full_attn_layers"]}
    w = cfg["sliding_window"]
    return [None if (i in full or not w) else w
            for i in range(cfg["num_layers"])]


def attention_flops(cfg: Dict, batch: int, sq: int, skv: int,
                    causal: bool = True) -> float:
    """Forward flops of attention's two products (QK^T and PV) over
    every layer: 4 a (query head, visible key, head dim)."""
    if cfg["family"] == "ssm":
        return 0.0
    per = FLASH_FWD_FLOPS * batch * cfg["num_heads"] * cfg["head_dim"]
    return float(sum(per * visible_keys(sq, skv, causal, w)
                     for w in windows(cfg)))


def forward_flops(cfg: Dict, batch: int, seq: int,
                  head_positions: Optional[int] = None) -> float:
    """One forward over ``batch`` sequences of ``seq`` tokens; the vocab
    projection at ``head_positions`` positions a sequence (default: all)."""
    hp = seq if head_positions is None else head_positions
    tokens = batch * seq
    return 2.0 * tokens * cfg["num_layers"] * layer_matmul_params(cfg) \
        + 2.0 * batch * hp * cfg["d_model"] * cfg["vocab_size"] \
        + attention_flops(cfg, batch, seq, seq)


def train_flops(cfg: Dict, batch: int, seq: int) -> float:
    """One training step: three times the forward with the loss over
    every position."""
    return 3.0 * forward_flops(cfg, batch, seq)


def prefill_flops(cfg: Dict, batch: int, seq: int) -> float:
    """One prefill that returns the last position's logits."""
    return forward_flops(cfg, batch, seq, head_positions=1)


def decode_flops(cfg: Dict, batch: int, context: int) -> float:
    """One decode step of ``batch`` sequences, each attending to
    ``context`` earlier positions plus its own (window-limited)."""
    flops = 2.0 * batch * (cfg["num_layers"] * layer_matmul_params(cfg)
                           + cfg["d_model"] * cfg["vocab_size"])
    if cfg["family"] != "ssm":
        per = FLASH_FWD_FLOPS * batch * cfg["num_heads"] * cfg["head_dim"]
        flops += sum(per * min(context + 1, w or context + 1)
                     for w in windows(cfg))
    return flops
