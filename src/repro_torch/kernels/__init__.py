"""Hand-written CUDA kernels for Hopper (sm_90a).

Each kernel package ships ``csrc/*.cu`` (the kernel, with a plain C
launcher), ``<name>.py`` (build and ctypes binding through ``_build``,
checked launch wrappers with launch counts), ``ref.py`` (the plain
PyTorch version) and ``ops.py`` (the public entry point: kernel for CUDA
tensors, plain version for CPU tensors).  Packages: ``bloom_probe``,
``paged_attention`` (decode over paged KV), ``flash_attention`` (forward
and backward; the entry point is an autograd ``Function`` whose backward
launches the dQ and dK/dV kernels on the card, from the forward's
per-row log-sum-exp), ``selective_scan`` (Mamba-1, v1 and fused in one
source; the fused entry point is a ``Function`` whose backward launches
the scan's backward kernel on the card).  On the CPU the two backwards
stay the reference's form: autograd through ``attention_ref`` and the
chunked scan ``ref.ssm_scan_chunked``; the backward kernels' plain
versions are ``attention_bwd_ref`` and ``selective_scan_fused_bwd_ref``.
"""
