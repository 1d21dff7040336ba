"""Bloom-filter probe: CUDA kernel, plain PyTorch version, entry points."""
