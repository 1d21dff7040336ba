"""PyTorch/CUDA port of the HHZS reproduction (hinted LSM-tree data
management on hybrid zoned storage, Li/Wang/Lee 2022).

It keeps the layout and names of the JAX package ``repro``, which stays
the reference the port is tested against.  Subpackages ported so far:
zoned, core, lsm, workloads (the store serving YCSB point reads) and
kernels (the Bloom probe as a CUDA kernel for Hopper).  The store's entry
points put their filter images and probes on the CUDA card unless the
caller passes ``torch_device="cpu"``.
"""
__version__ = "0.1.0"
