"""Granite-34B-code: 88-layer MQA (kv=1) llama-arch [arXiv:2405.04324; hf]."""
from ..config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128,
    source="arXiv:2405.04324; hf",
)
