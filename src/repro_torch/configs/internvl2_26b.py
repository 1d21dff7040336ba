"""InternVL2-26B backbone (InternLM2-20B side): the InternViT frontend is
a stub — input_specs provides precomputed patch embeddings occupying the
first vision_prefix positions [arXiv:2404.16821; hf]."""
from ..config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92553, head_dim=128,
    vision_prefix=256,
    source="arXiv:2404.16821; hf",
)
