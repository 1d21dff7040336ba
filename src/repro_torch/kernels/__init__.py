"""Hand-written CUDA kernels for Hopper (sm_90a).

Each kernel package ships ``csrc/*.cu`` (the kernel, with a plain C
launcher), ``<name>.py`` (build and ctypes binding through ``_build``,
checked launch wrappers with launch counts), ``ref.py`` (the plain
PyTorch version) and ``ops.py`` (the public entry point: kernel for CUDA
tensors, plain version for CPU tensors).  Packages: ``bloom_probe``,
``paged_attention`` (decode over paged KV), ``flash_attention`` (forward),
``selective_scan`` (Mamba-1, v1 and fused, two kernels in one source).
"""
