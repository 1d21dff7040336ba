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
  (``kernels/paged_attention``, ``kernels/flash_attention``);
* slice 3, the model's prefill and decode steps for the dense, ssm and
  hybrid families, with both selective scans as CUDA kernels
  (``kernels/selective_scan``);
* slice 7, training: data, optim (AdamW), checkpoint (the reference's
  on-disk layout), ft and ``launch.train.train_loop``, on one device,
  through the same kernels (their autograd ``Function``s recompute the
  backward through the plain versions);
* slice 8, the moe, encdec and vlm model families;
* slice 9, the rest of the storage system: obs (telemetry and the SLO
  control plane), the multi-tenant runner, ``ScenarioMatrix`` and the
  sweep driver, drift programs, the serving DES grid and the sharded
  cluster (``cluster``), every read through the Bloom-probe kernel.

Entry points (``lsm.DB``, ``cluster.ShardedDB``,
``workloads.ScenarioMatrix``, ``workloads.sweep.GridDBFactory``,
``workloads.run_serving``, ``serving.ServingEngine``,
``launch.train.train_loop``) put their data and kernels on the CUDA card
unless the caller passes ``torch_device="cpu"`` (``device="cpu"`` for the
train loop), which takes the kernels' plain PyTorch versions.
"""
__version__ = "0.2.0"
