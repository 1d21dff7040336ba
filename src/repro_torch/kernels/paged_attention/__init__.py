"""Paged decode attention: CUDA kernel, plain PyTorch version, entry point."""
