"""Hymba-1.5B: parallel attention + mamba heads per layer; SWA except a
few full-attention layers; ssm_state=16 [arXiv:2411.13676; hf].

Hymba meta-tokens are omitted (see DESIGN.md §Arch-applicability)."""
from ..config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    ssm_state=16, d_inner=3200,
    sliding_window=1024, full_attn_layers=(0, 16, 31),
    source="arXiv:2411.13676; hf",
)
