"""Model / shape / parallelism configuration.

``ModelConfig`` covers all assigned architecture families: dense decoder
transformers (GQA, qk-norm, QKV-bias, sliding window), MoE, Mamba-1 SSM,
hybrid attention+SSM (Hymba-style), encoder-decoder (Whisper backbone) and
VLM backbones (vision-prefix stub).  ``ShapeSpec`` defines the four assigned
input-shape cells; ``input_kind`` distinguishes training from decode
lowering (decode shapes lower ``serve_step`` with a KV cache, not
``train_step``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    # attention flavour
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: Optional[int] = None     # SWA width (tokens) or None
    # hybrid archs: full attention at these layer indices, SWA elsewhere
    full_attn_layers: Tuple[int, ...] = ()
    rope_theta: float = 10_000.0
    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (Mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    d_inner: int = 0                 # 0 -> 2 * d_model
    # encoder-decoder (Whisper backbone; conv frontend is a stub)
    encoder_layers: int = 0          # > 0 => enc-dec
    encoder_seq: int = 1500          # audio frame positions after conv stub
    # VLM backbone: first `vision_prefix` positions carry patch embeddings
    vision_prefix: int = 0
    norm_eps: float = 1e-6
    act: str = "swiglu"              # swiglu | gelu
    tie_embeddings: bool = False
    source: str = ""                 # provenance note ([arXiv/hf ref])

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_inner_(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, -(-self.d_model // 16))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context? SSM state and/or bounded
        sliding-window KV make decode cost independent of context length."""
        if self.family == "ssm":
            return True
        if self.family == "hybrid":
            return True              # SWA + SSM; few full-attn layers noted
        return self.sliding_window is not None

    def param_count(self) -> int:
        """Approximate parameter count (embedding + layers)."""
        d, f, hd = self.d_model, self.d_ff, self.head_dim_
        n_attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        if self.is_moe:
            n_mlp = self.num_experts * 3 * d * f + d * self.num_experts
        elif f > 0:
            n_mlp = 3 * d * f
        else:
            n_mlp = 0
        n_ssm = 0
        if self.has_ssm:
            di, N, rk = self.d_inner_, self.ssm_state, self.dt_rank
            n_ssm = d * 2 * di + di * self.ssm_conv + di * (rk + 2 * N) \
                + rk * di + di * N + di + di * d
        per_layer = n_attn * (self.family != "ssm") + n_mlp + n_ssm + 2 * d
        n = self.num_layers * per_layer + self.vocab_size * d
        if self.encoder_layers:
            n += self.encoder_layers * (n_attn + n_mlp + 2 * d)
            n += self.num_layers * n_attn    # decoder cross-attention
        if not self.tie_embeddings:
            n += self.vocab_size * d
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of num_experts)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_like = dataclasses.replace(self, num_experts=0, top_k=0,
                                         d_ff=0)
        return dense_like.param_count() \
            + self.num_layers * (self.top_k * 3 * d * f
                                 + d * self.num_experts)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=256,
            num_experts=min(self.num_experts, 4),
            top_k=min(self.top_k, 2),
            d_inner=128 if self.has_ssm else 0,
            ssm_state=min(self.ssm_state, 8) if self.has_ssm else 0,
            sliding_window=16 if self.sliding_window else None,
            full_attn_layers=(0,) if self.full_attn_layers else (),
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=8 if self.encoder_layers else 1500,
            vision_prefix=4 if self.vision_prefix else 0,
        )


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", seq_len=4096, global_batch=256,
                          kind="train"),
    "prefill_32k": ShapeSpec("prefill_32k", seq_len=32_768, global_batch=32,
                             kind="prefill"),
    "decode_32k": ShapeSpec("decode_32k", seq_len=32_768, global_batch=128,
                            kind="decode"),
    "long_500k": ShapeSpec("long_500k", seq_len=524_288, global_batch=1,
                           kind="decode"),
}


@dataclass(frozen=True)
class ParallelConfig:
    """How train/serve steps are partitioned over the mesh."""
    fsdp: bool = True                # shard params/optimizer over "data"
    remat: bool = True               # per-layer activation checkpointing
    scan_layers: bool = True         # stack layers, lax.scan over them
    # sequence parallelism: shard between-layer activations' seq dim over
    # "model" (7x residual-memory reduction at 256 chips; required for the
    # assigned train shapes to fit v5e HBM)
    seq_shard_activations: bool = True
    # serving
    kv_batch_axis: str = "data"
    # gradient accumulation microbatches (1 = none)
    grad_accum: int = 1


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    seed: int = 0
