"""Falcon-Mamba-7B: attention-free Mamba-1, d_ff=0
[arXiv:2410.05355; unverified]."""
from ..config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=65024, head_dim=64,
    ssm_state=16, d_inner=8192,
    source="arXiv:2410.05355; unverified",
)
