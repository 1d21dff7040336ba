"""Mixtral-8x22B: 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088; hf]."""
from ..config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=32768, head_dim=128,
    num_experts=8, top_k=2, sliding_window=4096,
    source="arXiv:2401.04088; hf",
)
