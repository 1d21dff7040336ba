"""PyTorch/CUDA port of the HHZS reproduction (hinted LSM-tree data
management on hybrid zoned storage, Li/Wang/Lee 2022).

It keeps the layout and names of the JAX package ``repro``, which stays
the reference the port is tested against.  Ported so far:

* slice 1, the store: zoned, core, lsm, workloads, and the Bloom probe as
  a CUDA kernel (``kernels/bloom_probe``);
* slice 2, LLM KV-cache serving over HHZS-tiered paged KV: config,
  configs, models (the dense decoder), serving (paged pools, tier
  managers, policies and ``ServingEngine(cfg, model, torch_device=...)``),
  with paged decode attention and flash attention forward as CUDA kernels
  (``kernels/paged_attention``, ``kernels/flash_attention``).

Entry points (``lsm.DB``, ``serving.ServingEngine``) put their data and
kernels on the CUDA card unless the caller passes ``torch_device="cpu"``,
which takes the kernels' plain PyTorch versions.
"""
__version__ = "0.2.0"
