"""Mamba-1 selective scan, v1 (precomputed bx) and fused: CUDA kernels,
plain PyTorch versions, entry points."""
