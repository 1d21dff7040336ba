#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch`` (Bloom probe, paged
decode attention, flash attention forward, the two selective scans), one
nvcc per source, all started together, into ``build/repro_torch/`` (the
Bloom probe's waited for first; the others compile while phases 1-4,
which launch it alone, run, and are waited for before phase 5), then:

1. kernels vs plain: both CUDA kernels against their plain PyTorch
   versions on the card and the numpy twins, bit for bit: the
   single-filter kernel on adversarial keys (0, 2**64-1, duplicates, the
   top bit set) and random non-members; the pairs kernel (keys hashed on
   the card) over a store image of filters of different widths, one of
   one word, at 4,096 keys with k mixed 1..16 and with k 1 and 16, one
   key, no pairs, and a filter of 2**27 - 1 words (every position wraps
   uint32);
2. identity: the same seeded YCSB-C cell (a closed-loop per-key probe,
   then an open loop with batched reads) at ``paper_keys // 16`` on
   ``torch_device="cuda"``, on ``torch_device="cpu"`` and on the host's
   numpy route: result rows byte-identical, ``tree.stats`` identical,
   kernels launched on the card only;
3. the real size: scheme HHZS at ``ScenarioConfig().paper_keys`` keys (the
   paper's 200 GiB at 1/SCALE), loaded with ``run_load``.  Two paths run,
   each with the launch counts zeroed just before it and read just after:
   the per-key path, a closed-loop YCSB-C probe that measures the service
   rate (one probe call per read, over all its levels); then the main
   path, YCSB-C open-loop at twice that rate with ``read_batch=64`` for
   at least 100k reads: one ``bloom_probe_pairs`` launch per
   ``get_batch`` with a filtered pair, for all its levels, plus the
   levels the tree re-probed at walk time (``tree.probe_calls``; such a
   call whose pairs all name one SST launches ``bloom_probe``); every
   launch one probe call, every read found, the store image resident;
4. kernels at the main path's shapes: the probe calls captured in phase 3
   again through kernel, plain version and numpy, compared bit for bit,
   and the read path's launch timed back to back with CUDA events beside
   the kernel's device time, its floor (one item) and the least time the
   card could take; the single-filter kernel on seeded calls at the main
   path's keys a call when the main path made none.

5. attention kernels vs plain: paged decode attention and flash attention
   forward against their plain PyTorch versions on the card, in fp32 and
   bf16, at the sweep shapes of ``tests/test_kernels.py``, flash at ragged
   prompt lengths (1000 and 1531, causal, GQA 2:1, D 128) and paged at the
   serving engine's shapes; then the redesigned kernels' edges: flash at
   Hymba-1.5B's prefill (B 4, 25 / 5 heads, S 2,048, D 64, full and
   1,024-window), G 5 and 3 at ragged S, D 16 to 256 (bf16 takes the
   tensor-core kernel, D 40 and 30 the CUDA-core one), each causal, full,
   64-window and 1,024-window; paged with lens 0, on a split's last and
   the next split's first position, a ragged tail after full splits, and
   block tables far past the context (empty splits); flash at the moe,
   encdec and vlm families' shapes: Whisper-base's encoder (B 4, 8 heads,
   S 1,500, D 64, non-causal) and cross-attention (448 and 1 queries
   against 1,500 keys), and, bf16 only, Mixtral-8x22B's layer (48 / 8
   heads of 128, 8,192 tokens, window 4,096; its plain version one KV
   head's group at a time: 12.9 GB of fp32 scores whole); the dense
   configs' groups: flash at Granite-34B's 48 / 1 heads of 128 (ragged
   S 1,531, under every mask), Qwen2.5-14B's 40 / 8 and Minitron-4B's
   24 / 8 (causal, S 1,000), paged at groups past a block's 16 rows (G
   48 and 32 on one KV head, G 17 on two: three chunks, two, and a full
   and a one-row chunk) at contexts past one split and at lens 0, 63
   and 64; fp32 within 2e-5, bf16 within 2e-2;
6. serving identity: Qwen3-1.7B at full width cut to 2 layers, fp32
   weights from one seeded generator, serves the same four requests on
   ``torch_device="cuda"`` and on ``"cpu"`` with a device KV pool small
   enough that sequences demote and decode from the host tier: tokens,
   manager stats and pool byte counters identical, each step's logits
   within 1e-4 of the CPU's relative to their largest magnitude (fp32 with
   TF32 off, so only the order of sums differs; a wrong kernel is off by
   O(1));
7. the serving path at full size: Qwen3-1.7B, all 28 layers, bf16 random
   weights (seed 0) on the card, the first 12 of the cell's 24 requests
   (cut for the time limit) of 512-1536 prompt tokens and 64 new tokens
   each through ``ServingEngine`` over HHZS-tiered paged KV,
   with the launch counts zeroed just before ``run`` and read just after:
   one flash launch per layer of each prefill (each counted by the kernel
   it took: fp32 goes to the CUDA-core kernel), one paged launch per layer
   of each decode step, no Bloom launch; tier migrations must fire;
8. attention kernels at the serving path's shapes: calls captured in
   phase 7 again through kernel, plain version and
   ``scaled_dot_product_attention`` (the library's time, never used by the
   port), compared and timed beside the least time the card could take;
9. scan kernels vs plain: selective scan v1 and the fused scan against
   their plain PyTorch versions on the card at the sweep shapes of
   ``tests/test_kernels.py`` and at T in {1, 1000, 2048} x di in {3200,
   8192}, N 16, within 1e-4; the fused kernel also against v1 given bx
   formed outside, and at each of its lanes-a-channel options (2, 4)
   whatever the wrapper picks, v1 at launch options (channels a block x
   ring stages: 8 x 1, 40 x 2, 256 x 3) whatever its plan picks and on
   its scalar route (bx offset by one float); then both kernels' edges:
   T 1, on, one below and one above the fused kernel's 32-step chunk,
   half of it, the backward's 8-step chunk and v1's 4-step stage, di
   3,000 (no multiple of any block's channels) and 37 (odd: 4-byte
   copies, v1's scalar route), N 1, 5, 8, decays all 0 (dt 500), all 1
   (dt 0) and 1 on every other step, and B 1 at Falcon-Mamba's width;
   the fused scan's backward at every case against its plain version
   and autograd through ``ssm_scan_chunked`` (each gradient within 1e-4
   of its largest, a rerun bit for bit), also at 8, 32, 104 and 128
   channels a block whatever its plan picks and on its scalar route
   (dt, x and dy one float past a 16-byte boundary), and at di 3,208 (no
   multiple of Hymba's plan's 104);
10. model identity: Falcon-Mamba-7B at full width cut to 2 layers and
   Hymba-1.5B cut to 3 (``layer_windows`` takes the full-attention layers
   modulo depth: at 2 every Hymba layer is full), fp32 weights, TF32 off.
   ``make_prefill_step`` on the card and on the CPU (Hymba's prompts past
   its 1,024-token window): next-token logits within 1e-4 relative to the
   largest; ``make_serve_step`` teacher-forcing a short prompt, then
   greedy: identical tokens.  On the card, the prefill's logits at every
   position of the served sequence against the decode's within the
   reference's 3e-2 (Hymba inside its window: its decode sees the whole
   context, as the reference's does); one scan (and flash) launch per
   layer of each prefill on the card, none on the CPU;
11. the serving path at full size: Falcon-Mamba-7B (64 layers) and
   Hymba-1.5B (32 layers), bf16 random weights (seed 0) made on the card,
   ``make_prefill_step`` on 4 prompts of 2,048 tokens, then
   ``make_serve_step`` on 4 sequences (64 prompt tokens teacher-forced, 64
   generated), counts zeroed before and read after each: one fused-scan
   launch per layer of the prefill, one flash launch per Hymba layer with
   its window exactly where ``layer_windows`` gives one, every one on the
   tensor-core kernel, no kernel in decode; finite logits.  After phase
   12, each model is made again and one prefill and 16 decode steps run
   under the profiler: the device's busy share of phase 11's wall time,
   and the prefill's device time split by operation, the fused scan's
   and flash's share of it measured (one scan launch a layer in the
   trace) (``phase11_busy``);
12. the scans at the path's shapes: fused-scan calls captured uniformly in
   phase 11 again through the kernel and its plain version, and through
   v1 with bx formed outside (not timed; v1's plan, channels a block and
   stages, beside its time), compared and timed beside the
   least time the card could take (no PyTorch call computes the scan)
   and the special-function units' time for its exponentials
   (``bound_sfu_ms``: one a (t, d, n) at 16 a clock an SM, at the SM's
   maximum clock);
   likewise Hymba's flash calls captured in phase 11 (windowed and full
   layers, bf16) against the plain version within 2e-2, timed beside
   their bound, ``scaled_dot_product_attention`` and the wrapper's other
   kernel, on the CUDA cores (``simt_ms``): the ``by_model`` entries of
   the flash row;
13. training identity: Qwen3-1.7B (2 layers), Falcon-Mamba-7B (2) and
   Hymba-1.5B (3) at full width, fp32 from one seeded ``init_state``,
   TF32 off, SyntheticLM batch 2 x 128 (Hymba, whose optimizer is also
   held, 2 x 256): one ``make_train_step`` step with
   remat on at grad_accum 1 and 2 on the card, each against one step on
   the CPU at grad_accum 1 (the same arithmetic, fp32 sums in another
   order), the launch counts zeroed just before and read just after
   each: loss, grad norm
   and lr within 1e-4 relative, every gradient (the first moment, 0.1 g
   times the clip scale) within 1e-4 of its largest, every parameter with
   a gradient on the CPU with one on the card, the new parameters bf16,
   launches exactly (1 + remat) x micro-batches x layers for each kernel
   (fp32 flash on the CUDA-core kernel); on the card a second step on
   the bf16 parameters (A_log and D included) runs to a finite loss.  The
   masters after the step are reported, not checked: AdamW's first step
   maps g to about g / (|g| + 1e-8), so gradients near 1e-8 that differ
   in their last bits move their masters by up to the learning rate;
   instead ``adamw.update`` runs on the card and the CPU on the same
   state and gradients (masters and moments within 1e-4, parameters
   within one bf16 step).  Then ``train_loop`` on Hymba's smoke config
   on the card, killed at step 5 and resumed from step 4's checkpoint to
   step 8, and the state it ends with saved and restored on the card
   into a fresh state's structure: every leaf equal after widening, in
   the fresh dtypes (A_log fp32);
14. Hymba-1.5B trains at full width and depth through ``train_loop``:
   bf16 random weights (seed 0), fp32 masters and moments, remat on, 6
   steps of SyntheticLM batches 4 x 2,048, no checkpoint, the counts
   zeroed just before and read just after: finite losses and grad norms,
   exactly 2 x 32 flash (all ``mma``) and 2 x 32 fused-scan launches a
   step and nothing else; seconds a step, tokens per second over steps
   2-6, peak memory; then one more step of the same state under the
   profiler's CUDA activity with the two Functions' backwards bracketed
   by CUDA events (``Spans``): device time by operation, the
   kernels' forwards, the plain attention backward, the chunked-scan
   backward and GEMMs, and the busy share (device time over the mean
   unprofiled step).  The flash and fused-scan rows of the ``kernels``
   line get a ``by_path`` entry with these launches;
15. family identity: OLMoE-1B-7B (2 layers), Whisper-base (whole: 6
   encoder and 6 decoder layers, frames [2, 1,500, 512]) and
   InternVL2-26B (2 layers, the first 256 positions vision embeddings)
   at full width, fp32 from one seeded ``init_model``, TF32 off, on the
   card and on the CPU: ``forward`` and ``make_prefill_step`` logits,
   and ``make_serve_step``'s teacher-forced then greedy decode (caches
   widened to fp32: in bf16 caches a k or v the two devices compute a few
   ulps apart can round to neighbouring values; Whisper's cross caches
   from ``encoder_kv``), within 1e-4 of
   the largest; greedy tokens, and every MoE call's experts and kept
   slots, identical; flash launches exactly one per attention call
   (decoder, encoder and cross layers of each forward, the encoder's
   layers for the cross caches, the cross layers of each decode step),
   on the CUDA-core kernel; then one ``make_train_step`` step of each
   family's smoke config on the card and the CPU: loss and grad norm
   within 1e-4, every parameter with a gradient on the card (the fp32
   router included), 2 flash launches per attention call (remat); and
   OLMoE's routing on tied gates (a zero router input: 64 equal gates;
   a router with two equal leading columns) on the card and the CPU:
   experts and kept slots identical, the lower expert first, as
   ``jax.lax.top_k`` takes ties; and OLMoE at a capacity factor of 64 /
   8, where no pair drops, its teacher-forced decode (fp32 caches)
   within 3e-2 of ``forward`` at every position of 2 x 64 tokens;
16. the moe, encdec and vlm families at full width: OLMoE-1B-7B (16
   layers) and InternVL2-26B (48 layers, 256 random vision positions)
   on 4 prompts of 2,048 tokens, Mixtral-8x22B cut to 12 of its 56
   layers on one prompt of 8,192 (twice its 4,096 window) and
   Whisper-base (6 + 6) on frames 4 x 1,500 and 4 prompts of 448: bf16
   random weights (seed 0) made on the card, ``make_prefill_step``,
   then (Whisper) the cross caches from ``encoder_kv``, then
   ``make_serve_step`` on B sequences from the prefill's own context:
   caches holding the k and v the prefill's flash calls took for all but
   the last 32 prompt positions, those 32 tokens forced, 32 generated
   (Mixtral's 4,096-slot ring from position 8,160, past its wrap);
   counts zeroed before and read after each: one flash launch per
   attention call, all on the tensor-core kernel, the decoder's with the
   model's window, decode launching only Whisper's 6 cross calls a step;
   finite logits; the decode's logits at the last prompt position within
   3e-2 of the prefill's on InternVL and Whisper (reported, not held, on
   the moe family: an expert the prefill dropped, a near-tie among 64
   gates that bf16 activations of the two paths break apart, or
   Mixtral's ring mask, changes them; phase 15 holds OLMoE's at a
   capacity factor with no drop, in fp32); the cut model leaves at
   least 8 GiB free.  Reported: seconds and tokens/s,
   pairs dropped by capacity, peak memory, one prefill's device time by
   operation and 16 decode steps' under the profiler (busy shares).  The
   first flash call of each signature is kept and timed afterwards with
   CUDA events beside its bound, its plain version and
   ``scaled_dot_product_attention``: the flash row's ``by_model``
   entries, its launches counted in ``by_path``;
17. the control plane, sweeps, drift, serving grid and cluster.  17a:
   one scenario matrix at ``paper_keys // 64`` keys a store of four cells,
   ``benchmarks/storage_exps.py``'s ``bench_control`` tenants ("prot" at
   0.25x and "bulk" at 1.2x a seeded B3 probe's rate, 16 servers) under
   its pi+knobs feedback policy, a ``rotate`` drift program, a 2-shard
   range cluster whose shard 1 crashes halfway and a 4-shard range
   cluster with the rebalancer on a hot range (batched reads of 16),
   run on the card, on the CPU, on the card in two spawned sweep
   workers, and on the card with telemetry off: rows byte-identical, the
   pairs kernel launched on the card and nothing on the CPU; one
   serving-grid cell (HHZS tiering) with its KV pages on the card and
   every resident page re-read after every decode step, its rows and
   stats the CPU's.  17b, on the card, counts zeroed before each cell
   and read after: ``bench_control``'s HHZS pi+knobs cell at
   ``paper_keys // 4`` keys for 900 virtual seconds, and
   ``bench_sharding``'s skew cell (4 range shards, the rebalancer every
   10 s, a hot range at 9x the probe's rate) for 160 of its 400 virtual
   seconds: wall seconds, throughput, p99s and goodput, rebalance moves,
   Bloom launches (at least one pairs launch a cell), the probe stage's
   host seconds and each shard's resident image bytes.  The Bloom rows of
   the ``kernels`` line count these paths' launches in ``by_path``;
18. the multi-device layer: one process joins a group of one rank
   (gloo for CPU tensors, NCCL for the card's, an in-process store; no
   fallback: a group that does not come up fails the script) and builds
   ``make_local_mesh(1)``; the group is destroyed at the end.  18a:
   OLMoE-1B-7B cut to 2 layers, fp32, TF32 off, ``make_prefill_step``
   with the sequence-sharded constraint (every MoE layer through
   ``moe_shard_map``) on 2 x 64 tokens at the default capacity factor
   (pairs drop), on the card's mesh and on a CPU mesh of the same group:
   experts, kept slots and drops identical, logits within 1e-4 of the
   largest; at capacity factor 8 (no drop) the sharded prefill on the
   card within 1e-4 of the plain one; one flash launch a layer, two
   all-to-alls and four all-gathers a MoE layer.  18b: OLMoE-1B-7B at
   full width and depth, bf16 random weights (seed 0) made on the card,
   the sharded prefill on 4 x 2,048 over the (1, 1) NCCL mesh, counts
   zeroed before and read after its first call: one flash launch a layer
   on the tensor-core kernel, two all-to-alls a layer; reported: seconds
   and tokens/s, pairs dropped against the pooled capacity, device time
   by operation (the sharded MoE's dispatch, experts and combine
   bracketed by CUDA events; NCCL; flash), the busy share, beside phase
   16's unsharded prefill.  The flash row counts 18b's launches in
   ``by_path``;
19. training on DTensor state and the dry run.  19a: ``train_loop`` at
   Qwen3-1.7B's full width and depth (bf16, random weights from seed 0,
   phase 13's 2 x 256 batch, 3 steps), first with no process group (one
   device), then over the (1, 1) mesh of a one-rank NCCL group (the state
   initialised under ``state_specs``, each batch placed under the batch
   specs): every step's loss, grad norm and lr within 1e-4, moments and
   masters within 1e-4 of each tensor's largest, parameters within one
   bf16 step; each loop's flash launches counted (two a layer a step, on
   the tensor-core kernel); step time, tokens/s, peak memory and the busy
   share of one more profiled step.  Both loops again at the smoke config
   saving their last step: the two checkpoints byte-identical, each
   restored in the other's layout leaf for leaf (a checkpoint of the whole
   1.7B state is 27 GB of npz).  The group is destroyed at the end.  19b:
   the dry run's cell Qwen3-1.7B x train_4k on the 16 x 16 production
   mesh of a fake group of 256 ranks (``launch/dryrun.py``, fake tensors
   on the host): its roofline record.  The flash row counts 19a's sharded
   loop's launches in ``by_path``;
20. the remaining dense configs.  20a: Qwen2.5-14B (QKV bias),
   Minitron-4B (a 256,000-token vocabulary) and Granite-34B (MQA, 48
   query heads on one KV head) at full width cut to 2 layers, fp32
   weights made on the card from one seeded generator and copied to the
   CPU, TF32 off, card against CPU: ``make_prefill_step`` on 2 x 64
   tokens, then 8 steps of ``make_serve_step`` (4 forced, fp32 caches):
   logits within 1e-4 of the largest, greedy tokens identical, one flash
   launch a layer of each prefill on the card; then Granite's model
   through ``ServingEngine`` on 2 requests of 40-100 prompt tokens, 8 new
   tokens each, over a device pool of three zones of 32 positions (a
   sequence decodes from the host tier): tokens, manager stats and pool
   byte counters identical, every forward's logits within 1e-4, one
   paged launch per layer of each decode step, every one at G 48.  20b:
   bf16 random weights (seed 0) made on the card, through phase 16's
   path: Qwen2.5-14B (48 layers) and Minitron-4B (32) whole, Granite-34B
   cut to 64 of its 88 layers (1.06 GB a layer; the cut leaves at least
   8 GiB free), each ``make_prefill_step`` on 4 prompts of 2,048 tokens
   (one flash launch a layer, on the tensor-core kernel) and
   ``make_serve_step`` from the prefill's context; then Granite's cut
   model, the same weights, through ``ServingEngine``: 4 requests of
   512-1,536 prompt tokens, 16 new tokens each, counts zeroed before
   ``run`` and read after: one paged launch per layer of each decode
   step, all at G 48, every logit finite.  Reported: seconds, tokens/s,
   peak memory, each prefill's device time by operation and busy share;
   each model's first flash call and the engine's first paged call timed
   with CUDA events beside the bound (paged at G 48: the larger of its
   bytes and its fp32 operations), the plain version and
   ``scaled_dot_product_attention`` (over the gathered pages for paged):
   the flash and paged rows' ``by_model`` entries and ``by_path`` counts;
21. the repo's four examples through the port's twins
   (``examples/*_torch.py``), each ``main`` on the card with the launch
   counts zeroed just before it and read just after: quickstart and
   ycsb_demo ``--quick`` print the reference example's lines byte for
   byte (``tests/data/examples_reference``), every read probed by the
   pairs kernel; serve_paged (qwen3-1.7b smoke, pages of 8 positions,
   weights drawn on the CPU from seed 0) prefills on flash and decodes on
   paged, its counters those of a CPU run of the twin; train_lm at its
   default size (D 32, bf16) prints the reference example's model and
   restarts lines, its loss falls, and every attention call runs flash's
   forward and both backward kernels on the tensor cores.  The first call
   of each kernel in each twin (flash's forward and backward, paged) is
   kept and held against its plain version (attention 2e-5 / 2e-2, the
   backward 1e-4 / 2e-2 of each gradient's largest).  The twins'
   launches join the Bloom-pairs, flash, paged and flash-backward rows.

TF32 is off for matmuls and cuDNN (the defaults for matmuls), so fp32
products on the card are full fp32.  Each phase prints one JSON line; the
card's name and power limit come from nvidia-smi.  The last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is non-zero and no result prints.  Exits non-zero at once when no
CUDA card is visible.  ``--phases 9,10`` runs only the phases named (for a
short first call after a kernel edit); it prints no ``kernels`` or ``ok``
line.  Each phase's line carries its seconds.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.config import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bloom_probe import bloom_probe as kernel  # noqa: E402
from repro_torch.kernels.bloom_probe import ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention as flash_kernel)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_ref)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention as paged_kernel)
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref)
from repro_torch.kernels.selective_scan import (  # noqa: E402
    fused as fused_kernel)
from repro_torch.kernels.selective_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.selective_scan import (  # noqa: E402
    selective_scan as scan_kernel)
from repro_torch.kernels.selective_scan.ref import (  # noqa: E402
    selective_scan_fused_bwd_ref, selective_scan_fused_ref,
    selective_scan_ref, ssm_scan_chunked)
from repro_torch.core.middleware import AdmissionConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (make_local_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.launch.train import to_device, train_loop  # noqa: E402
from repro_torch.lsm import DB, SCALE, ScenarioConfig, filters  # noqa: E402
from repro_torch.lsm.tree import LSMTree  # noqa: E402
from repro_torch.models import (encoder_kv, forward,  # noqa: E402
                                init_caches, init_model, init_state,
                                layer_windows, make_prefill_step,
                                make_serve_step, make_train_step,
                                state_shapes)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe_sharded  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.sharding import (activation_constraint,  # noqa: E402
                                  state_specs)
from torch.distributed.tensor import DTensor  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from repro_torch.workloads import (YCSB, PoissonArrivals,  # noqa: E402
                                   ScenarioMatrix, ServingPool,
                                   ServingWorkload, TenantSpec,
                                   WorkloadSpec, build_program, run_load,
                                   run_open_loop, run_serving,
                                   run_workload, serving_arrivals)
from repro_torch.workloads.sweep import GridDBFactory, run_sweep  # noqa
from repro_torch.zoned.device import MiB  # noqa: E402
from repro_torch.zoned.faults import FaultSpec  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (guide's table)
CUDA_CORE_OPS_PER_S = 67e12   # H100 SXM non-tensor-core fp32 rate
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core rate
OPS_PER_PROBE = 8             # mul, add, mod, shift, add, shift, and, test
MAIN_READS = 100_000
FIRST = 16                    # a path's first probe calls, checked
SAMPLE = 64                   # plus a uniform sample, checked and timed
SOURCE = "src/repro_torch/kernels/bloom_probe/csrc/bloom_probe.cu"
REPLACES = {
    "bloom_probe": "src/repro/kernels/bloom_probe/bloom_probe.py:25",
    "bloom_probe_pairs": "src/repro/kernels/bloom_probe/ref.py:49",
    "paged_attention":
        "src/repro/kernels/paged_attention/paged_attention.py:29",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:29",
    "selective_scan":
        "src/repro/kernels/selective_scan/selective_scan.py:25",
    "selective_scan_fused": "src/repro/kernels/selective_scan/fused.py:25",
}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py
# phase 7: the serving path at full size; the run takes the first
# SERVE_RUN_REQUESTS of the cell's SERVE_REQUESTS (its record's ``cut``),
# one wave of max_batch 12 where 24 make two, for the script's time limit:
# 8 of the 12 placed on the card and 4 on the host, so tiers still mix
SERVE_REQUESTS = 24
SERVE_RUN_REQUESTS = 12
SERVE_NEW_TOKENS = 64
ALL_PHASES = tuple(range(1, 22))


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def t32(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(a, np.uint32).view(np.int32)).to(dev)


def t64(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# phase 1: kernels vs plain on crafted inputs
# ----------------------------------------------------------------------
def adversarial_keys(rng, n):
    keys = rng.integers(0, 2**63, n).astype(np.uint64)
    keys[0] = np.uint64(0)
    keys[1] = np.uint64(2**64 - 1)
    keys[2] = np.uint64(2**64 - 1)
    keys[3:6] = keys[6]
    keys[7:16] = rng.integers(2**63, 2**64, 9, dtype=np.uint64)  # top bit
    return keys


def mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got != want).sum().item())


def pairs_case(rng, n, per_key, slot_off, slot_words, ks):
    """Host operands of the pairs form: ``n`` adversarial keys, each in
    ``per_key`` pairs on random slots (the last pair on key n - 1), k
    drawn from ``ks``."""
    keys = adversarial_keys(rng, max(n, 16))[:n]
    p = n * per_key
    pair_key = rng.integers(0, n, p).astype(np.int32)
    if p:
        pair_key[-1] = n - 1
    pair_slot = rng.integers(0, len(slot_off), p).astype(np.int32)
    pair_k = np.array(ks, np.uint8)[rng.integers(0, len(ks), p)]
    return keys, pair_key, pair_slot, pair_k


def check_pairs(keys, pair_key, pair_slot, pair_k, slot_off, slot_words,
                words_dev, words_host) -> dict:
    """The pairs kernel (through its checked wrapper), its plain version
    on the card and the numpy twin on one case."""
    dev = words_dev.device
    dargs = (t64(keys.view(np.int64), dev),
             torch.from_numpy(pair_key).to(dev),
             torch.from_numpy(pair_slot).to(dev),
             torch.from_numpy(pair_k).to(dev), t64(slot_off, dev),
             torch.from_numpy(slot_words).to(dev), words_dev)
    got = kernel.bloom_probe_pairs(*dargs)
    want = ref.bloom_probe_pairs_ref(*dargs)
    host = filters.probe_slots_np(keys, pair_key, pair_slot, pair_k,
                                  slot_off, slot_words, words_host)
    return {"n": len(keys), "pairs": len(pair_key),
            "hits": int(host.sum()),
            "mismatch_plain": mismatches(got, want),
            "mismatch_numpy": int((got.cpu().numpy().astype(bool)
                                   != host).sum())}


def phase_kernels(dev) -> dict:
    rng = np.random.default_rng(0)
    out = {}
    for bpk in (4, 10, 16):
        member = adversarial_keys(rng, 4096)
        nw, k = filters.filter_params(len(member), bpk)
        lo, hi = filters.split_hash(member)
        bits = filters.build_filter_np(lo, hi, nw, k)
        built = ref.build_filter(t32(lo, dev), t32(hi, dev), nw, k)
        check(np.array_equal(built.cpu().numpy().view(np.uint32), bits),
              "plain build_filter on the card == numpy builder")
        q = np.concatenate([member[:1024],
                            np.array([0, 2**64 - 1, 1], np.uint64),
                            rng.integers(0, 2**64, 20_000, dtype=np.uint64)])
        qlo, qhi = filters.split_hash(q)
        args = (t32(qlo, dev), t32(qhi, dev), t32(bits, dev))
        got = kernel.bloom_probe(*args, k)
        want = ref.bloom_probe_ref(*args, k)
        host = filters.probe_np(qlo, qhi, bits, k)
        out[f"single_bpk{bpk}"] = {
            "n": len(q), "mismatch_plain": mismatches(got, want),
            "mismatch_numpy": int((got.cpu().numpy().astype(bool)
                                   != host).sum()),
            "no_false_negatives": bool(got[:1024].all().item())}
    # a store image: filters of different widths, the last of one word,
    # and keys hashed on the card against every slot, k mixed 1..16
    chunks, offs, nws, cur, member = [], [], [], 0, None
    for n in (64, 300, 1000, 10_000, 7, 1):
        keys = rng.integers(0, 2**63, n).astype(np.uint64)
        member = keys if n == 1000 else member
        nw, k = filters.filter_params(n, 10)
        lo, hi = filters.split_hash(keys)
        chunks.append(filters.build_filter_np(lo, hi, nw, k))
        offs.append(cur)
        nws.append(nw)
        cur += nw
    check(nws[-1] == 1, "phase 1: a filter of one word")
    image = np.concatenate(chunks)
    slot_off, slot_words = np.array(offs, np.int64), np.array(nws, np.int32)
    image_dev = t32(image, dev)
    mixed = tuple(range(1, 17))
    cases = {
        "pairs_4096_keys_mixed_k": pairs_case(rng, 4096, 3, slot_off,
                                              slot_words, mixed),
        "pairs_k1_and_k16": pairs_case(rng, 4096, 2, slot_off, slot_words,
                                       (1, 16)),
        "pairs_one_key": pairs_case(rng, 1, 12, slot_off, slot_words, mixed),
        "pairs_none": pairs_case(rng, 5, 0, slot_off, slot_words, mixed),
    }
    # members of slot 2's filter among the keys, so some pairs hit
    cases["pairs_4096_keys_mixed_k"][0][16:272] = member[:256]
    for name, (keys, pk, ps, kk) in cases.items():
        out[name] = check_pairs(keys, pk, ps, kk, slot_off, slot_words,
                                image_dev, image)
    # the widest filter the kernel takes: 2**27 - 1 words (nbits 2**32 -
    # 32, so every position wraps uint32), dense random bits (~97% set,
    # so k up to 16 probes run to their end), and a slot inside it
    big = 2**27 - 1
    g = torch.Generator(device=dev).manual_seed(1)
    words = torch.zeros(big, dtype=torch.int32, device=dev)
    for _ in range(5):
        words |= torch.randint(-2**31, 2**31 - 1, (big,), dtype=torch.int32,
                               device=dev, generator=g)
    b_off, b_words = np.array([0, 12_345], np.int64), \
        np.array([big, 1000], np.int32)
    keys, pk, ps, kk = pairs_case(rng, 4096, 2, b_off, b_words, mixed)
    out["pairs_words_2pow27_minus_1"] = check_pairs(
        keys, pk, ps, kk, b_off, b_words, words,
        words.cpu().numpy().view(np.uint32))
    del words
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for name, r in out.items():
        check(r["mismatch_plain"] == 0 and r["mismatch_numpy"] == 0,
              f"phase 1 {name}: kernel == plain == numpy")
        check(r.get("no_false_negatives", True), f"phase 1 {name}: members")
    check(out["pairs_none"]["pairs"] == 0, "phase 1: a call of no pairs")
    check(0 < out["pairs_words_2pow27_minus_1"]["hits"]
          < out["pairs_words_2pow27_minus_1"]["pairs"],
          "phase 1: the widest filter both hits and misses")
    return out


# ----------------------------------------------------------------------
# phases 2 and 3: the store
# ----------------------------------------------------------------------
ROUTES = {"cuda": ("torch", "cuda"), "cpu": ("torch", "cpu"),
          "numpy": ("numpy", "cpu")}


def loaded_db(route: str, n_keys: int) -> DB:
    """An HHZS store of ``n_keys`` loaded keys on one probe route: the
    card (``cuda``), the plain PyTorch version (``cpu``) or the host's
    numpy path (``numpy``)."""
    impl, dev = ROUTES[route]
    sc = ScenarioConfig()
    sc = dataclasses.replace(sc, lsm=dataclasses.replace(sc.lsm,
                                                         filter_impl=impl))
    db = DB("HHZS", sc, torch_device=dev)
    run_load(db, n_keys)
    db.flush_all()
    return db


def open_loop(db: DB, n_keys: int, rate: float, n_reads: int):
    """YCSB-C open-loop at ``rate`` with batched reads, for about
    ``n_reads`` arrivals."""
    return run_open_loop(db, YCSB["C"], PoissonArrivals(rate),
                         duration=n_reads / rate, n_keys=n_keys,
                         read_batch=64, seed=1)


def phase_identity(n_keys: int) -> dict:
    rows, stats, launched, wall = {}, {}, {}, {}
    for route in ROUTES:
        kernel.reset_launches()
        t0 = time.perf_counter()
        db = loaded_db(route, n_keys)
        probe = run_workload(db, YCSB["C"], n_ops=2000, n_keys=n_keys)
        res = open_loop(db, n_keys, 2.0 * probe.throughput, 22_000)
        torch.cuda.synchronize()
        wall[route] = time.perf_counter() - t0
        rows[route] = json.dumps([dataclasses.asdict(probe), res.to_json()],
                                 sort_keys=True)
        stats[route] = dict(db.tree.stats)
        launched[route] = dict(kernel.launches)
    out = {"n_keys": n_keys,
           "rows_identical": len(set(rows.values())) == 1,
           "stats_identical": all(v == stats["cuda"] for v in stats.values()),
           "row_bytes": len(rows["cuda"]), "launches": launched,
           "wall_s": wall, "filter_probes": stats["cuda"]["filter_probes"]}
    check(out["rows_identical"],
          "phase 2: cuda, cpu and numpy rows equal, byte for byte")
    check(out["stats_identical"],
          "phase 2: cuda, cpu and numpy tree.stats equal")
    check(launched["cuda"]["bloom_probe_pairs"] > 0,
          "phase 2: the cuda run launched the pairs kernel")
    check(all(v == 0 for r in ("cpu", "numpy")
              for v in launched[r].values()),
          "phase 2: the cpu and numpy runs launched no kernel")
    return out


class Recorder:
    """Wraps ``filters.Prober``'s two calls (the tree's calls into the
    kernel package) and keeps each call's arguments, as they are: the tree
    builds them afresh for every call and never changes them after, and a
    store image is never changed once made.  It also counts the tree's
    ``get_batch`` calls and times its probe stage (its ``_probe_slots``
    and ``_probe_pairs_real`` calls, a call inside another once, as
    ``tools/route_cost.py`` does).  Nothing is computed while the path
    runs; ``summary`` and ``kept`` read the calls afterwards."""

    NAMES = ("bloom_probe", "bloom_probe_pairs")

    def __init__(self, tree):
        self.calls = {n: [] for n in self.NAMES}
        self.tree, self.batches = tree, 0
        self.stage_s, self._depth = 0.0, 0
        self._orig = (filters.Prober.probe, filters.Prober.probe_pairs)
        self._calls0 = dict(tree.probe_calls)
        rec, orig_batch = self, tree.get_batch

        def get_batch(keys):
            rec.batches += 1
            return (yield from orig_batch(keys))

        def timed(fn):
            def stage(*a):
                if rec._depth:
                    return fn(*a)
                rec._depth, t0 = 1, time.perf_counter()
                try:
                    return fn(*a)
                finally:
                    rec.stage_s += time.perf_counter() - t0
                    rec._depth = 0
            return stage
        self._tree_attrs = {
            "get_batch": get_batch,
            **{name: timed(getattr(tree, name))
               for name in ("_probe_slots", "_probe_pairs_real")}}

    def __enter__(self):
        rec, (single, pairs) = self, self._orig

        def probe(prober, image, slot, lo, hi, k):
            rec.calls["bloom_probe"].append((image, slot, lo, hi, k))
            return single(prober, image, slot, lo, hi, k)

        def probe_pairs(prober, image, keys, pair_key, pair_slot, pair_k):
            rec.calls["bloom_probe_pairs"].append(
                (image, keys, pair_key, pair_slot, pair_k))
            return pairs(prober, image, keys, pair_key, pair_slot, pair_k)

        filters.Prober.probe, filters.Prober.probe_pairs = probe, probe_pairs
        for name, fn in self._tree_attrs.items():
            setattr(self.tree, name, fn)
        return self

    def __exit__(self, *exc):
        filters.Prober.probe, filters.Prober.probe_pairs = self._orig
        for name in self._tree_attrs:
            delattr(self.tree, name)
        self._calls1 = dict(self.tree.probe_calls)

    def counts(self) -> dict:
        return {n: len(c) for n, c in self.calls.items()}

    def tree_calls(self) -> dict:
        """The tree's probe calls of the run, by kind."""
        return {k: v - self._calls0[k] for k, v in self._calls1.items()}

    def summary(self) -> dict:
        """Probe calls, pairs probed and distinct keys per call."""
        pairs, single = self.calls["bloom_probe_pairs"], \
            self.calls["bloom_probe"]
        keys = {"bloom_probe_pairs": [len(np.unique(c[1])) for c in pairs],
                "bloom_probe": [len(np.unique(
                    (c[2].astype(np.uint64) << np.uint64(32))
                    | c[3].astype(np.uint64))) for c in single]}
        n_pairs = sum(len(c[2]) for c in pairs) + \
            sum(len(c[2]) for c in single)
        n = max(1, len(pairs) + len(single))
        return {"probe_calls": self.counts(), "tree_calls": self.tree_calls(),
                "get_batch_calls": self.batches, "probe_stage_s": self.stage_s,
                "pairs_probed": n_pairs,
                "mean_pairs_per_call": n_pairs / n,
                "mean_keys_per_call": sum(map(sum, keys.values())) / n,
                "mean_keys_per_call_by_kernel": {
                    name: sum(v) / max(1, len(v)) for name, v in keys.items()}}

    def kept(self, name: str):
        """(sample, first): a seeded uniform sample of ``SAMPLE`` calls,
        and the first ``FIRST`` calls."""
        cs = self.calls[name]
        rng = np.random.default_rng(0)
        pick = sorted(rng.choice(len(cs), min(SAMPLE, len(cs)),
                                 replace=False)) if cs else []
        return [cs[j] for j in pick], cs[:FIRST]


def run_path(db: DB, fn):
    """Run one path with the launch counts zeroed just before it and read
    just after: (result, launches, recorder, wall seconds)."""
    with Recorder(db.tree) as rec:
        kernel.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = dict(kernel.launches)
    return res, launched, rec, wall


def phase_main(n_keys: int):
    t0 = time.perf_counter()
    db = loaded_db("cuda", n_keys)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    stats = db.tree.stats
    fp0, hits0 = stats["filter_probes"], stats["hits"]
    probe, pk_launched, pk_rec, pk_s = run_path(
        db, lambda: run_workload(db, YCSB["C"], n_ops=2000, n_keys=n_keys))
    fp1, hits1 = stats["filter_probes"], stats["hits"]
    rate = 2.0 * probe.throughput
    res, launched, rec, run_s = run_path(
        db, lambda: open_loop(db, n_keys, rate, int(MAIN_READS * 1.1)))
    row = res.to_json()
    # the store's filter image, as the store holds it now
    image = db.tree._store_image()
    image_words = sum(len(s.filter_words) for lvl in db.tree.levels
                      for s in lvl)
    resident = (image.resident.n_words * 4
                if image.resident is not None else 0)
    perkey = {"reads": probe.n_ops, "wall_s": pk_s,
              "launches": pk_launched, "filter_probes": fp1 - fp0,
              "found": hits1 - hits0, **pk_rec.summary()}
    main = {"reads": row["op_counts"]["read"], "wall_s": run_s,
            "launches": launched,
            "filter_probes": stats["filter_probes"] - fp1,
            "found": stats["hits"] - hits1, **rec.summary()}
    main["pairs_surplus"] = main["pairs_probed"] - main["filter_probes"]
    calls = main["tree_calls"]
    reprobes = calls["reprobe_epoch"] + calls["reprobe_mixed_k"]
    main["reprobes"] = reprobes
    out = {
        "scheme": db.scheme, "n_keys": n_keys,
        "levels": [len(lvl) for lvl in db.tree.levels],
        "filter_words": image_words, "resident_image_bytes": resident,
        "slots": image.resident.n_slots if resident else 0,
        "load_s": load_s, "service_rate": probe.throughput,
        "offered_rate": row["offered_rate"],
        "max_queue_depth": row["max_queue_depth"],
        "perkey_path": perkey, "main_path": main,
    }
    for name, path, r in (("per-key", perkey, pk_rec),
                          ("main", main, rec)):
        check(all(n == path["launches"][k] for k, n in r.counts().items()),
              f"phase 3 {name} path: one kernel launch per probe call")
        # YCSB-C reads only loaded keys: a false negative would miss one
        check(path["found"] == path["reads"],
              f"phase 3 {name} path: every read found its key")
    # a per-key read probes all its levels' candidates in one call; a
    # second call only for an SST installed while the read ran
    check(sum(pk_launched.values()) >= probe.n_ops,
          "phase 3 per-key path: one probe call per read")
    check(perkey["pairs_probed"] >= perkey["filter_probes"],
          "phase 3 per-key path: every candidate the walk met was probed "
          "on the card")
    check(main["reads"] >= MAIN_READS, "phase 3: at least 100k reads")
    check(launched["bloom_probe_pairs"] > 0,
          "phase 3: the pairs kernel launched on the main path")
    check(calls["batch"] <= main["get_batch_calls"]
          and sum(launched.values()) == calls["batch"] + reprobes,
          "phase 3: one launch per get_batch with a filtered pair, plus "
          "the re-probes")
    check(main["pairs_probed"] >= main["filter_probes"],
          "phase 3: every Bloom probe the main path's walk counted went "
          "through a kernel")
    check(main["mean_keys_per_call_by_kernel"]["bloom_probe_pairs"] >= 32,
          "phase 3: at least 32 keys per batched launch")
    check(resident == 4 * image_words and image.resident.n_slots
          == sum(len(lvl) for lvl in db.tree.levels),
          "phase 3: every SST's filter is resident on the card")
    check(all(np.isfinite(v) for v in row["latency_p"].values()),
          "phase 3: finite latencies")
    return out, row, rec, pk_rec


# ----------------------------------------------------------------------
# phase 4: the captured main-path calls, again and timed
# ----------------------------------------------------------------------
OPS_PER_HASH = 14    # splitmix64: 3 shifts, 3 xors, 2 64-bit multiplies
BYTES_PER_SLOT = 12  # a slot's int64 offset and int32 word count


def touched(lo, hi, off, nw, ks, image):
    """(distinct words gathered, probes done) under the kernel's early
    exit at the first clear bit, pair p running at most ``ks[p]``
    probes."""
    nbits = nw.astype(np.uint32) * np.uint32(32)
    ks = np.asarray(ks, np.int64)
    alive = ks > 0
    words, probes = [np.zeros(0, np.int64)], 0
    with np.errstate(over="ignore"):
        for i in range(int(ks.max()) if len(ks) else 0):
            pos = (lo + np.uint32(i) * hi) % nbits
            widx = off + (pos >> np.uint32(5)).astype(np.int64)
            words.append(widx[alive])
            probes += int(alive.sum())
            bit = (image[widx] >> (pos & np.uint32(31))) & np.uint32(1)
            alive &= bit.astype(bool) & (i + 1 < ks)
    return np.unique(np.concatenate(words)).size, probes


def cuda_ms(fn, calls, reps):
    for c in calls:
        fn(*c)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for c in calls:
            fn(*c)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


def device_ms(fn, calls, kernel_symbol: str):
    """Mean device time of one launch from ``torch.profiler``'s CUDA
    activity (the kernel alone, without the host's launch path), or None
    when the profiler records no device time for it."""
    return device_ms_each({kernel_symbol: (fn, calls)})[kernel_symbol]


def device_ms_each(runs: dict) -> dict:
    """``device_ms`` for several kernels in one profiler session: runs maps
    a kernel symbol to (fn, calls)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn, calls in runs.values():
            for c in calls:
                fn(*c)
        torch.cuda.synchronize()
    events = prof.key_averages()
    out = {}
    for symbol in runs:
        total_us, count = 0.0, 0
        for ev in events:
            if symbol in ev.key:
                total_us += getattr(ev, "device_time_total",
                                    getattr(ev, "cuda_time_total", 0.0))
                count += ev.count
        out[symbol] = total_us / count / 1e3 if count and total_us > 0 \
            else None
    return out


class Replay:
    """One captured call on the card: ``check`` runs it through the
    kernel's checked wrapper, the plain version and numpy; ``lean`` is
    the call as the read path makes it (``launch_*`` on device addresses,
    into an output made here), for timing; ``bound`` its least time (s)
    in bytes and in operations."""

    def __init__(self, name: str, call, host_words):
        self.name, self.call = name, call
        if name == "bloom_probe_pairs":
            image, keys, pk, ps, kk = call
            res = image.resident
            dev = res.device
            self.args = (t64(keys.view(np.int64), dev),
                         torch.from_numpy(pk).to(dev),
                         torch.from_numpy(ps).to(dev),
                         torch.from_numpy(kk).to(dev), *image.tensors)
            self.out = torch.empty(len(pk), dtype=torch.uint8, device=dev)
            lo, hi = filters.split_hash(keys)
            lo, hi = lo[pk], hi[pk]
            off, nw = image.slot_off[ps], image.slot_words[ps]
            self.host = (keys, pk, ps, kk, image.slot_off, image.slot_words,
                         host_words)
            ptrs = [t.data_ptr() for t in self.args[:4]]
            self.lean = (res, len(keys), len(pk), *ptrs, self.out.data_ptr())
            words, probes = touched(lo, hi, off, nw, kk, host_words)
            in_bytes = (8 * len(keys) + 10 * len(pk)
                        + BYTES_PER_SLOT * len(np.unique(ps)))
            self.bound = ((in_bytes + 4 * words) / HBM_BYTES_PER_S,
                          (OPS_PER_HASH * len(pk) + OPS_PER_PROBE * probes)
                          / CUDA_CORE_OPS_PER_S)
            self.items = len(pk)
        else:
            image, slot, lo, hi, k = call
            res = image.resident
            dev = res.device
            off, nw = int(image.slot_off[slot]), int(image.slot_words[slot])
            self.args = (t32(lo, dev), t32(hi, dev),
                         image.words[off:off + nw], k)
            self.out = torch.empty(len(lo), dtype=torch.int32, device=dev)
            self.host = (lo, hi, host_words[off:off + nw], k)
            self.lean = (res, off, nw, len(lo), self.args[0].data_ptr(),
                         self.args[1].data_ptr(), k, self.out.data_ptr())
            words, probes = touched(
                lo, hi, np.zeros(len(lo), np.int64), np.full(len(lo), nw),
                np.full(len(lo), k), host_words[off:off + nw])
            self.bound = ((12 * len(lo) + 4 * words) / HBM_BYTES_PER_S,
                          OPS_PER_PROBE * probes / CUDA_CORE_OPS_PER_S)
            self.items = len(lo)

    def check(self) -> tuple:
        """(mismatches against plain and numpy, max abs difference)."""
        fn_k, fn_p = KERNELS[self.name][:2]
        got, want = fn_k(*self.args), fn_p(*self.args)
        host = (filters.probe_slots_np if self.name == "bloom_probe_pairs"
                else filters.probe_np)(*self.host)
        mism = mismatches(got, want) + int(
            (got.cpu().numpy().astype(bool) != host).sum())
        worst = int((got.int() - want.int()).abs().max().item()) \
            if got.numel() else 0
        return mism, worst

    def round_trip(self, prober) -> None:
        """The call through ``filters.Prober`` as the tree makes it:
        pack, copy over, launch, copy back, synchronise."""
        if self.name == "bloom_probe_pairs":
            prober.probe_pairs(*self.call)
        else:
            prober.probe(*self.call)

    def one_pair(self) -> tuple:
        """The same call cut to its first item: the launch floor."""
        lean = list(self.lean)
        lean[2 if self.name == "bloom_probe_pairs" else 3] = 1
        return tuple(lean)


# name: (checked wrapper, plain version, lean launcher)
KERNELS = {"bloom_probe": (kernel.bloom_probe, ref.bloom_probe_ref,
                           kernel.launch_single),
           "bloom_probe_pairs": (kernel.bloom_probe_pairs,
                                 ref.bloom_probe_pairs_ref,
                                 kernel.launch_pairs)}


def seeded_single_calls(rec: "Recorder", n_keys: int) -> list:
    """Single-filter calls at the main path's mean keys per pairs call,
    for when the main path made none: seeded store keys (the reads' key
    space) against random slots of the main path's last store image, with
    each slot's k."""
    pairs = rec.calls["bloom_probe_pairs"]
    image = pairs[-1][0]
    n = max(1, round(rec.summary()["mean_keys_per_call_by_kernel"]
                     ["bloom_probe_pairs"]))
    rng = np.random.default_rng(7)
    calls = []
    for _ in range(SAMPLE):
        slot = int(rng.integers(len(image.slot_k)))
        lo, hi = filters.split_hash(
            rng.integers(0, n_keys, n).astype(np.uint64))
        calls.append((image, slot, lo, hi, int(image.slot_k[slot])))
    return calls


def round_trip_ms(timed: list, reps: int = 5) -> float:
    """Host time of one probe call through a ``filters.Prober``, each
    ending in its stream's synchronise (after one warm-up pass)."""
    prober = filters.Prober()
    for r in timed:
        r.round_trip(prober)
    t0 = time.perf_counter()
    for _ in range(reps):
        for r in timed:
            r.round_trip(prober)
    return 1e3 * (time.perf_counter() - t0) / (reps * len(timed))


def phase_captured(rec: Recorder, pk_rec: Recorder, launched: dict,
                   pk_launched: dict, n_keys: int) -> list:
    """Every kept call of both paths is checked against the plain version
    and numpy; the main path's sampled calls are also timed, so the times
    and bounds are those of its mix of shapes (the single-filter kernel's
    at seeded calls of the main path's keys a call when the main path
    made none).  ``ms`` times the read path's launch (``launch_*`` on
    device addresses) back to back with CUDA events; ``device_ms`` is the
    profiler's time of the kernel alone and ``floor_ms`` the same for one
    item (``one_item_ms`` the back-to-back time at one item: the launch
    path alone; ``round_trip_ms`` the host time of the whole call through
    ``filters.Prober``: pack, copies, launch, synchronise).  The bound of
    a call is the larger of its bytes (keys 8 a key, pairs 9 in and 1
    out, slots 12 each, the single form 12 a key, each distinct filter
    word the early-exit probe reads 4) over HBM bandwidth and its integer
    operations (a hash 14, a probe 8) over the CUDA-core rate."""
    kernels = []
    host_words = {}

    def words_of(image):
        if id(image) not in host_words:
            host_words[id(image)] = (image, image.words.cpu().numpy()
                                     .view(np.uint32))
        return host_words[id(image)][1]

    for name, (_, fn_p, fn_lean) in KERNELS.items():
        sample, first = rec.kept(name)
        seeded = not sample
        if seeded:
            sample = seeded_single_calls(rec, n_keys)
        kept = sample + first + [c for part in pk_rec.kept(name)
                                 for c in part]
        mism, worst = 0, 0
        timed = []
        for j, call in enumerate(kept):
            r = Replay(name, call, words_of(call[0]))
            m, w = r.check()
            mism, worst = mism + m, max(worst, w)
            if j < len(sample):
                timed.append(r)
        check(len(timed) > 0, f"phase 4: {name} calls timed")
        check(mism == 0, f"phase 4: {name} kernel == plain == numpy on "
              "the captured inputs of both paths")
        t_bytes = [r.bound[0] for r in timed]
        t_ops = [r.bound[1] for r in timed]
        lean = [r.lean for r in timed]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launched[name],
            "launches_per_key_path": pk_launched[name],
            "seeded_calls": seeded,
            "mismatches": mism, "max_abs_err": worst,
            "ms": cuda_ms(fn_lean, lean, 50),
            "checked_ms": cuda_ms(lambda r: KERNELS[name][0](*r.args),
                                  [(r,) for r in timed], 10),
            "plain_ms": cuda_ms(fn_p, [r.args for r in timed], 5),
            "bound_ms": 1e3 * float(np.mean(np.maximum(t_bytes, t_ops))),
            "bound_by": ("bytes" if np.mean(t_bytes) >= np.mean(t_ops)
                         else "operations"),
            "library_ms": None,
            "device_ms": device_ms(fn_lean, lean, f"{name}_kernel"),
            "floor_ms": device_ms(fn_lean, [timed[0].one_pair()] * 50,
                                  f"{name}_kernel"),
            # the same back to back at one item: the launch path alone
            "one_item_ms": cuda_ms(fn_lean, [r.one_pair() for r in timed],
                                   50),
            "round_trip_ms": round_trip_ms(timed),
            "checked_calls": len(kept), "timed_calls": len(timed),
            "mean_items_per_call": float(np.mean([r.items for r in timed]))})
    host_words.clear()
    return kernels


# ----------------------------------------------------------------------
# phase 5: attention kernels vs plain on seeded inputs
# ----------------------------------------------------------------------
# the last two: Qwen2.5-14B's (40 / 8 heads) and Minitron-4B's (24 / 8)
# layer at D 128, G 5 and 3
FLASH_CASES = [(1, 4, 4, 256, 64), (2, 8, 2, 512, 64), (1, 8, 1, 256, 128),
               (1, 16, 8, 1000, 128), (1, 16, 8, 1531, 128),
               (2, 40, 8, 1000, 128), (2, 24, 8, 1000, 128)]
FLASH_MASKS = [(True, None), (False, None), (True, 64)]
# the edges of the redesigned kernels, each under FLASH_EDGE_MASKS: G 5 and
# 3 at ragged S (not a multiple of the 64-key tile) at D 64 and 128, D 16,
# 48 (padded to 64) and 256, D 40 (bf16 takes the CUDA-core kernel), D
# 30 (rows loaded a value at a time in fp32 too), and Granite-34B's MQA,
# G 48 on one KV head of 128
FLASH_EDGE = [(2, 25, 5, 1531, 64), (1, 15, 5, 1531, 128),
              (1, 9, 3, 1531, 64), (1, 6, 2, 997, 128), (1, 6, 3, 200, 16),
              (1, 4, 1, 100, 48), (1, 4, 2, 333, 256), (1, 4, 2, 100, 40),
              (1, 6, 3, 77, 30), (1, 48, 1, 1531, 128)]
FLASH_EDGE_MASKS = [(True, None), (False, None), (True, 64), (True, 1024)]
# Hymba-1.5B's prefill (B 4, 25 / 5 heads, S 2,048, D 64): its full and
# windowed layers
FLASH_HYMBA = (4, 25, 5, 2048, 64)
FLASH_HYMBA_MASKS = [(True, None), (True, 1024)]
# the moe, encdec and vlm families' new shapes, (b, h, kv, sq, d, skv):
# Whisper-base's encoder (non-causal, S 1,500, D 64) and its
# cross-attention against the 1,500 frames from 448 decoder positions and
# from one (a decode step), in fp32 and bf16; Mixtral-8x22B's layer (48 /
# 8 heads of 128, 8,192 tokens, window 4,096), bf16 only
FLASH_FAMILY = [(4, 8, 8, 1500, 64, 1500), (4, 8, 8, 448, 64, 1500),
                (4, 8, 8, 1, 64, 1500)]
FLASH_MIXTRAL = (1, 48, 8, 8192, 128, 8192)
PLAIN_SCORES_BYTES = 4 << 30  # attention_plain splits calls past this
# the backward kernels against their plain version and autograd, each
# gradient relative to its largest; and a call whose last rows see no key
# (S 300 against 100 keys, window 64: rows 163 on), forward and backward:
# the -1e30 fill's uniform weights (the forward's mean of v), causal and
# not
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FLASH_MASKED = (1, 4, 2, 300, 64, 100)
FLASH_MASKED_MASKS = [(True, 64), (False, 64)]
# (b, kv, g, pages, page_size, max_pages, d); the fourth is the engine's
# at Qwen3-1.7B, then groups past a block's 16 rows: Granite-34B's G 48
# on one KV head (three chunks; its engine's shape last), G 32 (two) and
# G 17 on two KV heads (a full chunk and one of a row), contexts past one
# split
PAGED_CASES = [(2, 4, 2, 16, 16, 4, 64), (3, 2, 4, 32, 8, 8, 128),
               (1, 1, 8, 8, 16, 2, 64), (1, 8, 2, 512, 16, 96, 128),
               (2, 1, 48, 256, 16, 96, 128), (2, 1, 32, 256, 16, 96, 128),
               (3, 2, 17, 128, 16, 40, 128), (1, 1, 48, 512, 16, 96, 128)]
# the split's edges, lens given per sequence: lens 0, the last position of
# a split (63) and the first of the next (64), one or two full splits and
# a ragged tail, tables far longer than the context (empty splits), page
# size 8, G 16 at D 256 and G 1 at D 32; lens 0, 63 and 64 at G 48, 32
# and 17
PAGED_EDGE = [((3, 8, 2, 64, 16, 8, 128), (0, 63, 64)),
              ((3, 1, 48, 64, 16, 8, 128), (0, 63, 64)),
              ((3, 1, 32, 64, 16, 8, 128), (0, 63, 64)),
              ((3, 2, 17, 64, 16, 8, 128), (0, 63, 64)),
              ((2, 8, 2, 64, 16, 8, 128), (127, 100)),
              ((2, 4, 4, 256, 16, 96, 128), (150, 1535)),
              ((1, 2, 8, 512, 16, 4000, 64), (700,)),
              ((2, 2, 2, 64, 8, 40, 64), (71, 200)),
              ((1, 1, 16, 16, 16, 8, 256), (77,)),
              ((2, 4, 1, 32, 16, 12, 32), (191, 5))]


def within(got: torch.Tensor, want: torch.Tensor, tol: float) -> tuple:
    """(max abs error, |got - want| <= tol + tol * |want| everywhere)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    return float(err.max()), bool((err <= tol + tol * w.abs()).all())


def randn(rng, shape, dtype, dev) -> torch.Tensor:
    a = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(dev, dtype)


def flash_case(rng, b, h, kv, s, d, dtype, dev, skv=None):
    """q [b, h, s, d] and k, v [b, kv, skv, d] (skv defaults to s)."""
    skv = s if skv is None else skv
    return tuple(randn(rng, shape, dtype, dev) for shape in
                 ((b, h, s, d), (b, kv, skv, d), (b, kv, skv, d)))


def attention_plain(q, k, v, causal=True, window=None):
    """``attention_ref``; a call whose fp32 scores would pass
    PLAIN_SCORES_BYTES (Mixtral's 8,192 x 8,192 a head: 12.9 GB) runs it
    one KV head's query group at a time (``per_kv_head``)."""
    return per_kv_head(lambda *a, **kw: (attention_ref(*a, **kw),), q, k, v,
                       causal=causal, window=window)[0]


def per_kv_head(fn, q, k, v, *rest, **kw):
    """``fn`` on q/k/v (and the rest, shaped as q) one KV head's query
    group at a time when the call's fp32 scores would pass
    PLAIN_SCORES_BYTES, the outputs joined along the head axis (the
    groups share nothing), else in one call; ``fn`` returns a tuple."""
    b, h, sq, _ = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if 4 * b * h * sq * skv <= PLAIN_SCORES_BYTES:
        return fn(q, k, v, *rest, **kw)
    g = h // kvh
    parts = [fn(q[:, i * g:(i + 1) * g].contiguous(), k[:, i:i + 1],
                v[:, i:i + 1], *(t[:, i * g:(i + 1) * g] for t in rest),
                **kw)
             for i in range(kvh)]
    return tuple(torch.cat(ts, dim=1) for ts in zip(*parts))


def attention_grads_autograd(q, k, v, dout, causal=True, window=None):
    """(dq, dk, dv) by autograd through ``attention_ref``."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        out = attention_ref(*qkv, causal=causal, window=window)
        return torch.autograd.grad(out, qkv, dout)


def flash_bwd_errors(q, k, v, causal, window) -> dict:
    """The backward kernels on one seeded call (their forward's out and
    log-sum-exp, a seeded dout laid out as the model's layers hand it
    back: [B, Sq, H, D] memory seen as [B, H, Sq, D]) against
    ``attention_bwd_ref`` and autograd through ``attention_ref``, each
    gradient relative to its largest, and a second launch on the same
    inputs bit for bit."""
    out, lse = flash_kernel.flash_attention_fwd(q, k, v, causal=causal,
                                                window=window, with_lse=True)
    b, h, sq, d = q.shape
    dout = torch.randn((b, sq, h, d), generator=torch.Generator(q.device)
                       .manual_seed(sq), device=q.device,
                       dtype=torch.float32).to(q.dtype).transpose(1, 2)
    return flash_bwd_held(q, k, v, out, lse, dout, causal, window)


def flash_bwd_held(q, k, v, out, lse, dout, causal, window) -> dict:
    """The backward kernels on one call (the forward's out and lse, and
    dout) against ``attention_bwd_ref`` and autograd, and a second launch
    bit for bit: ``flash_bwd_errors``'s record."""
    got = flash_kernel.flash_attention_bwd(q, k, v, out, lse, dout,
                                           causal=causal, window=window)
    again = flash_kernel.flash_attention_bwd(q, k, v, out, lse, dout,
                                             causal=causal, window=window)
    ref = per_kv_head(attention_bwd_ref, q, k, v, out, dout, causal=causal,
                      window=window)
    auto = per_kv_head(attention_grads_autograd, q, k, v, dout,
                       causal=causal, window=window)
    tol = FLASH_BWD_TOL[q.dtype]
    errs = {f"d{n}_vs_{kind}": card_rel_err(x, y)
            for kind, want in (("plain", ref), ("autograd", auto))
            for n, x, y in zip("qkv", got, want)}
    return {"errors": errs, "ok": all(e <= tol for e in errs.values()),
            "bitwise_repeat": all(torch.equal(x, y)
                                  for x, y in zip(got, again)),
            "variant": flash_kernel.bwd_variant(q.dtype, q.shape[3])}


def paged_case(rng, b, kv, g, pages, ps, mp, d, dtype, dev, lens=None):
    q = randn(rng, (b, kv * g, d), dtype, dev)
    kp = randn(rng, (pages, ps, kv, d), dtype, dev)
    vp = randn(rng, (pages, ps, kv, d), dtype, dev)
    tables = rng.integers(0, pages, (b, mp)).astype(np.int32)
    lens = (rng.integers(1, mp * ps, (b,)) if lens is None
            else np.array(lens)).astype(np.int32)
    return (q, kp, vp, torch.from_numpy(tables).to(dev),
            torch.from_numpy(lens).to(dev))


def phase_attention_kernels(dev) -> dict:
    """Both attention kernels' forward, and flash's backward (every
    forward case, and the rows that see no key), against their plain
    versions in fp32 and bf16."""
    rng = np.random.default_rng(5)
    masked_rng = np.random.default_rng(55)
    out, back = {}, {}

    def flash(dtype, shape, masks, gen=rng):
        for causal, window in masks:
            q, k, v = flash_case(gen, *shape[:5], dtype, dev, *shape[5:])
            tag = f"{dname}_{'x'.join(map(str, shape))}" \
                f"_causal{int(causal)}_window{window}"
            got = flash_kernel.flash_attention_fwd(
                q, k, v, causal=causal, window=window)
            want = attention_plain(q, k, v, causal=causal, window=window)
            err, ok = within(got, want, TOL[dtype])
            out[f"flash_{tag}"] = {
                "max_abs_err": err, "ok": ok,
                "variant": flash_kernel.variant(dtype, shape[4])}
            del got, want
            back[f"flash_bwd_{tag}"] = flash_bwd_errors(q, k, v, causal,
                                                        window)
            del q, k, v

    def paged(dtype, shape, lens=None):
        args = paged_case(rng, *shape, dtype, dev, lens)
        err, ok = within(paged_kernel.paged_attention_decode(*args),
                         paged_attention_ref(*args), TOL[dtype])
        name = f"paged_{dname}_{'x'.join(map(str, shape))}"
        out[name + ("" if lens is None else
                    f"_lens{'-'.join(map(str, lens))}")] = {
            "max_abs_err": err, "ok": ok,
            "splits": paged_kernel.split_plan(shape[5], shape[4]),
            "chunks": paged_kernel.group_chunks(shape[1] * shape[2],
                                                shape[1])}

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for shape in FLASH_CASES:
            flash(dtype, shape,
                  FLASH_MASKS if shape[3] < 1000 else FLASH_MASKS[:1])
        for shape in FLASH_EDGE:
            flash(dtype, shape, FLASH_EDGE_MASKS)
        flash(dtype, FLASH_HYMBA, FLASH_HYMBA_MASKS)
        for shape in FLASH_FAMILY:
            flash(dtype, shape, [(False, None)])
        if dtype == torch.bfloat16:
            flash(dtype, FLASH_MIXTRAL, [(True, 4096)])
        flash(dtype, FLASH_MASKED, FLASH_MASKED_MASKS, gen=masked_rng)
        for shape in PAGED_CASES:
            paged(dtype, shape)
        for shape, lens in PAGED_EDGE:
            paged(dtype, shape, lens)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit(phase5_backward=back)          # before its checks
    for name, r in out.items():
        check(r["ok"], f"phase 5 {name}: kernel within tolerance of plain")
    for name, r in back.items():
        check(r["ok"], f"phase 5 {name}: dq, dk, dv within "
              f"{FLASH_BWD_TOL} of the plain backward and of autograd")
        check(r["bitwise_repeat"], f"phase 5 {name}: a second backward "
              "launch gives the same bits")
    return out


# ----------------------------------------------------------------------
# phases 6 and 7: the serving engine
# ----------------------------------------------------------------------
def reset_attention_launches() -> None:
    paged_kernel.reset_launches()
    flash_kernel.reset_launches()


def attention_launches() -> dict:
    return {**paged_kernel.launches, **flash_kernel.launches}


def record_logits(eng: ServingEngine) -> list:
    """Keep a CPU copy of the logits of every forward of ``eng``."""
    log, logits = [], eng._logits

    def kept(req, tokens):
        out = logits(req, tokens)
        log.append(out.float().cpu())
        return out
    eng._logits = kept
    return log


def engine_identity(cfg, models: dict, prompts: list, new: int,
                    **pools) -> tuple:
    """Each device's copy of a model (``models``: device -> model, the
    card's first, then the CPU's) through ServingEngine on the same
    ``prompts``, ``new`` tokens each, over ``pools``, the counts zeroed
    just before ``run`` and read just after.  Returns (the comparison of
    the first device's run with the CPU's, the runs)."""
    runs = {}
    for dev, model in models.items():
        eng = ServingEngine(cfg, model, torch_device=dev, **pools)
        log = record_logits(eng)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=new))
        with AttentionRecorder({"flash_attention": set(),
                                "paged_attention": set()}) as rec:
            reset_attention_launches()
            t0 = time.perf_counter()
            stats = eng.run(max_steps=200)
            sync(dev)
            runs[dev] = {
                "stats": stats, "wall_s": time.perf_counter() - t0,
                "tokens": [r.out_tokens
                           for r in sorted(eng.done, key=lambda r: r.rid)],
                "pool_bytes": [(p.bytes_written, p.bytes_read)
                               for p in (eng.hbm, eng.host)],
                "staged_bytes": eng.staged_bytes, "logits": log,
                "launches": attention_launches(),
                "paged_groups": sorted(set(rec.groups))}
        del eng
    card, cpu = (runs[d] for d in models)
    rel = [rel_err(g, c) for g, c in zip(card["logits"], cpu["logits"])]
    return {"steps_compared": len(rel), "max_rel_logit_err": max(rel),
            "tokens_identical": card["tokens"] == cpu["tokens"],
            "stats_identical": card["stats"] == cpu["stats"],
            "pool_bytes_identical": card["pool_bytes"] == cpu["pool_bytes"],
            "staged_bytes": {d: r["staged_bytes"] for d, r in runs.items()},
            "launches": {d: r["launches"] for d, r in runs.items()},
            "paged_groups": card["paged_groups"],
            "wall_s": {d: r["wall_s"] for d, r in runs.items()},
            "stats": card["stats"], "pool_bytes": card["pool_bytes"]}, runs


def phase_serving_identity(card_dev: str = "cuda") -> dict:
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), num_layers=2)
    model = init_model(cfg, seed=0, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(34)     # a draw whose lengths make the
    lens = []                           # manager demote and promote
    while len(lens) < 4:
        n = int(rng.integers(100, 301))
        if n % 16:
            lens.append(n)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    # the card gets a copy: ServingEngine moves its model in place
    ident, runs = engine_identity(
        cfg, {card_dev: copy.deepcopy(model), "cpu": model}, prompts, 16,
        page_size=16, pages_per_zone=8, hbm_zones=4, host_zones=32,
        cache_zones=1, max_batch=4)
    torch.cuda.empty_cache()
    gpu, cpu = runs[card_dev], runs["cpu"]
    out = {"layers": cfg.num_layers, "prompt_lens": lens, **ident}
    check(out["tokens_identical"], "phase 6: card and CPU tokens identical")
    check(out["stats_identical"], "phase 6: card and CPU stats identical")
    check(out["pool_bytes_identical"],
          "phase 6: card and CPU pool byte counters identical")
    check(len(gpu["logits"]) == len(cpu["logits"]) == 4 * 16,
          "phase 6: one logits vector per forward")
    check(out["max_rel_logit_err"] <= 1e-4,
          "phase 6: card logits within 1e-4 of the CPU's")
    check(gpu["stats"]["demotions"] > 0 and gpu["stats"]["promotions"] > 0
          and gpu["staged_bytes"] > 0
          and gpu["staged_bytes"] == cpu["staged_bytes"],
          "phase 6: sequences demoted, promoted and decoded from the host "
          "tier")
    check(gpu["launches"] == {"paged_attention": 4 * 15 * cfg.num_layers,
                              "flash_attention": 4 * cfg.num_layers,
                              "flash_attention_bwd": 0},
          "phase 6: one kernel launch per layer of each forward on the card, "
          "no backward")
    check(not any(cpu["launches"].values()),
          "phase 6: the CPU run launched no kernel")
    return out


class AttentionRecorder:
    """Wraps the engine's two attention entry points and keeps a copy of
    the arguments of the calls whose index is in ``keep``.  The engine
    reuses its pools, so a kept paged call keeps its pages gathered into
    a compact pool of their own, with the block table 0..n-1: the kernel
    reads the same K/V through it.  ``groups`` holds every paged call's
    query heads per KV head."""

    def __init__(self, keep: dict):
        self.keep = keep
        self.calls = {name: [] for name in keep}
        self.seen = {name: 0 for name in keep}
        self.groups = []
        self._orig = (flash_ops.flash_attention, paged_ops.paged_attention)

    def _kept(self, name: str) -> bool:
        i = self.seen[name]
        self.seen[name] += 1
        return i in self.keep[name]

    def flash(self, q, k, v, causal=True, window=None):
        if self._kept("flash_attention"):
            check(causal and window is None, "phase 7: causal prefill")
            self.calls["flash_attention"].append(
                (q.clone(), k.clone(), v.clone()))
        return self._orig[0](q, k, v, causal, window)

    def paged(self, q, k_pages, v_pages, tables, lens):
        self.groups.append(q.shape[1] // k_pages.shape[2])
        if self._kept("paged_attention"):
            pages = tables[0].long()
            self.calls["paged_attention"].append((
                q.clone(), k_pages[pages], v_pages[pages],
                torch.arange(len(pages), dtype=torch.int32,
                             device=tables.device)[None], lens.clone()))
        return self._orig[1](q, k_pages, v_pages, tables, lens)

    def __enter__(self):
        flash_ops.flash_attention, paged_ops.paged_attention = \
            self.flash, self.paged
        return self

    def __exit__(self, *exc):
        flash_ops.flash_attention, paged_ops.paged_attention = self._orig


def serve_requests(cfg, model, dev, n_requests: int, new: int, keep: dict,
                   **pools) -> tuple:
    """``model`` through ServingEngine over ``pools`` on ``n_requests``
    seeded requests of 512-1,536 prompt tokens and ``new`` new tokens
    each, the counts zeroed just before ``run`` and read just after, the
    attention calls whose index is in ``keep`` kept.  Returns (record,
    AttentionRecorder)."""
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, model, torch_device=dev, **pools)
    sync(dev)
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    lens = rng.integers(512, 1537, n_requests)
    for i, n in enumerate(lens):
        eng.submit(Request(
            rid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
            max_new_tokens=new))
    n_decode = n_requests * (new - 1)
    # wall time of prefills and decodes (each forward ends in a sync: the
    # argmax goes to the host) and of the host tier's staging copies (a
    # copy from pageable memory returns when it is done), and a count of
    # non-finite logits kept on the card
    wall = {"prefill": 0.0, "decode": 0.0, "stage": 0.0}
    forward, logits, stage = eng._forward_tokens, eng._logits, eng._stage
    nonfinite = torch.zeros((), dtype=torch.int64, device=dev)

    def timed(req, tokens):
        t = time.perf_counter()
        nxt = forward(req, tokens)
        wall["decode" if req.out_tokens else "prefill"] += \
            time.perf_counter() - t
        return nxt

    def checked(req, tokens):
        out = logits(req, tokens)
        nonfinite.add_((~torch.isfinite(out)).sum())
        return out

    def staged(host_layer, pages):
        t = time.perf_counter()
        out = stage(host_layer, pages)
        wall["stage"] += time.perf_counter() - t
        return out
    eng._forward_tokens, eng._logits, eng._stage = timed, checked, staged
    torch.cuda.reset_peak_memory_stats()
    with AttentionRecorder(keep) as rec:
        reset_model_launches()
        t0 = time.perf_counter()
        stats = eng.run(max_steps=1000)
        sync(dev)
        run_s = time.perf_counter() - t0
        launched = model_launches()
        variants = dict(flash_kernel.variant_launches)
    out = {
        "model": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "heads": [cfg.num_heads, cfg.num_kv_heads],
        "params": sum(p.numel() for p in model.parameters()),
        "requests": n_requests,
        "prompt_tokens": int(lens.sum()), "mean_prompt": float(lens.mean()),
        "new_tokens_each": new, "decode_tokens": n_decode,
        "load_s": load_s, "run_s": run_s, "prefill_s": wall["prefill"],
        "decode_s": wall["decode"], "stage_s": wall["stage"],
        "prefill_tokens_per_s": int(lens.sum()) / wall["prefill"],
        "decode_tokens_per_s": n_decode / wall["decode"],
        "decode_ms_per_token": 1e3 * wall["decode"] / n_decode,
        "staged_bytes": eng.staged_bytes,
        "pool_bytes": {p.name: {"written": p.bytes_written,
                                "read": p.bytes_read}
                       for p in (eng.hbm, eng.host)},
        "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launched, "flash_variants": variants,
        "paged_groups": sorted(set(rec.groups)),
        "all_tokens": all(len(r.out_tokens) == new for r in eng.done),
        "nonfinite_logits": int(nonfinite), "stats": stats}
    del eng
    return out, rec


def check_served(out: dict, tag: str) -> None:
    """serve_requests' checks common to phases 7 and 20b: every request
    done with all its tokens, one flash launch per layer of each prefill
    (each on one of its two kernels) and one paged launch per layer of
    each decode step, no other kernel, every logit finite."""
    n, launched = out["layers"], out["launches"]
    check(out["stats"]["done"] == out["requests"] and out["all_tokens"],
          f"{tag}: every request done with all its tokens")
    check(launched["flash_attention"] == n * out["requests"]
          and sum(out["flash_variants"].values())
          == launched["flash_attention"],
          f"{tag}: one flash launch per layer of each prefill, each on one "
          "of its two kernels")
    check(launched["paged_attention"] == n * out["decode_tokens"],
          f"{tag}: one paged launch per layer of each decode step")
    check(sum(launched.values()) == launched["paged_attention"]
          + launched["flash_attention"],
          f"{tag}: no other kernel (no Bloom launch, no scan)")
    check(out["nonfinite_logits"] == 0, f"{tag}: every logit is finite")


def phase_serving_main(dev: str = "cuda",
                       n_requests: int = SERVE_REQUESTS):
    cfg = get_config("qwen3-1.7b")
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    pick = np.random.default_rng(7)
    keep = {"flash_attention": set(pick.choice(
                n_requests * cfg.num_layers, 8, replace=False).tolist()),
            "paged_attention": set(pick.choice(
                n_requests * (SERVE_NEW_TOKENS - 1) * cfg.num_layers, 24,
                replace=False).tolist())}
    out, rec = serve_requests(cfg, model, dev, n_requests, SERVE_NEW_TOKENS,
                              keep, page_size=16, pages_per_zone=8,
                              hbm_zones=64, host_zones=192, cache_zones=2,
                              max_batch=12)
    out["load_s"] += init_s
    out["cut"] = SERVE_REQUESTS - n_requests
    check_served(out, "phase 7")
    check(out["stats"]["demotions"] + out["stats"]["host_placements"] > 0,
          "phase 7: tier migrations fired")
    del model
    torch.cuda.empty_cache()
    return out, rec


# ----------------------------------------------------------------------
# phase 8: the captured attention calls, again and timed
# ----------------------------------------------------------------------
def flash_causal(q, k, v):
    return flash_kernel.flash_attention_fwd(q, k, v, causal=True)


def flash_causal_ref(q, k, v):
    return attention_ref(q, k, v, causal=True)


# name: (kernel wrapper, plain version, kernel symbol, wrapper module)
ATTENTION = {"paged_attention": (paged_kernel.paged_attention_decode,
                                 paged_attention_ref, "paged_decode_kernel",
                                 paged_kernel),
             "flash_attention": (flash_causal, flash_causal_ref,
                                 "flash_fwd_kernel", flash_kernel)}


def sdpa_gqa() -> bool:
    """Whether this PyTorch's scaled_dot_product_attention takes
    ``enable_gqa``; without it the library call gets K/V repeated to the
    query heads (outside the timed call)."""
    x = torch.zeros(1, 2, 1, 8, device="cuda")
    try:
        F.scaled_dot_product_attention(x, x[:, :1], x[:, :1],
                                       enable_gqa=True)
        return True
    except TypeError:
        return False


def library_call(name: str, call, gqa: bool):
    """(fn, args) of the one PyTorch call that computes the same function:
    scaled_dot_product_attention, over the gathered K/V for paged."""
    if name == "flash_attention":
        q, k, v = call
        causal = True
    else:
        q, kp, vp, _, lens = call
        n = int(lens[0]) + 1
        kvh, d = kp.shape[2], kp.shape[3]
        k, v = (p.reshape(-1, kvh, d)[:n].transpose(0, 1)[None].contiguous()
                for p in (kp, vp))
        q = q[:, :, None, :]
        causal = False
    if not gqa:
        g = q.shape[1] // k.shape[1]
        k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    kw = {"enable_gqa": True} if gqa else {}
    return (lambda q_, k_, v_: F.scaled_dot_product_attention(
        q_, k_, v_, is_causal=causal, **kw)), (q, k, v)


def attention_bound(name: str, call) -> tuple:
    """(bytes / HBM rate, fp32 ops / CUDA-core rate) in seconds: inputs
    read once (for paged only the context's K/V rows), the output written
    once; 4 flops per (query head, visible key, head dim): 2 for q.k and
    2 for p.v."""
    if name == "paged_attention":
        q, kp, _, _, lens = call
        n = int(lens[0]) + 1
        kvh, d = kp.shape[2], kp.shape[3]
        nbytes = (2 * n * kvh * d + 2 * q.numel()) * kp.element_size()
        ops = 4 * q.shape[1] * d * n
    else:
        q, k, _ = call
        b, h, s, d = q.shape
        nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        ops = 4 * b * h * d * (s * (s + 1) // 2)
    return nbytes / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S


def phase_attention_captured(rec: AttentionRecorder, launched: dict,
                             flash_variants: dict) -> list:
    gqa = sdpa_gqa()
    dev_ms = device_ms_each({symbol: (fn_k, rec.calls[name])
                            for name, (fn_k, _, symbol, _) in
                            ATTENTION.items()})
    kernels = []
    for name, (fn_k, fn_p, symbol, module) in ATTENTION.items():
        calls = rec.calls[name]
        check(len(calls) == len(rec.keep[name]),
              f"phase 8: every kept {name} call captured")
        worst, ok = 0.0, True
        for c in calls:
            err, good = within(fn_k(*c), fn_p(*c), TOL[torch.float32])
            worst, ok = max(worst, err), ok and good
        check(ok, f"phase 8: {name} kernel within 2e-5 of plain on the "
              "captured calls")
        lib = [library_call(name, c, gqa) for c in calls]
        lib_fn, lib_args = lib[0][0], [a for _, a in lib]
        t_bytes, t_ops = zip(*(attention_bound(name, c) for c in calls))
        if name == "paged_attention":
            sizes = [int(c[4][0]) + 1 for c in calls]
            extra = {"mean_splits": float(np.mean(
                [paged_kernel.split_plan(c[3].shape[1], c[1].shape[1])[1]
                 for c in calls]))}
        else:
            sizes = [c[0].shape[2] for c in calls]
            extra = {"launches_by_variant": dict(flash_variants)}
        kernels.append({
            "name": name, "route": "cuda",
            "source": str(module.SOURCE.relative_to(ROOT)),
            "replaces": REPLACES[name], "launches": launched[name],
            "max_abs_err": worst, "dtype": "float32",
            "ms": cuda_ms(fn_k, calls, 20),
            "plain_ms": cuda_ms(fn_p, calls, 3),
            "bound_ms": 1e3 * float(np.mean(np.maximum(t_bytes, t_ops))),
            "bound_by": ("bytes" if np.mean(t_bytes) >= np.mean(t_ops)
                         else "operations"),
            "library_ms": cuda_ms(lib_fn, lib_args, 20),
            "library": "scaled_dot_product_attention" + (
                "(enable_gqa)" if gqa else " (K/V repeated to H heads)"),
            "device_ms": dev_ms[symbol],
            "timed_calls": len(calls),
            ("mean_context" if name == "paged_attention"
             else "mean_prompt"): float(np.mean(sizes)), **extra})
    return kernels


# ----------------------------------------------------------------------
# phase 9: the selective scan kernels vs plain on seeded inputs
# ----------------------------------------------------------------------
# the sweep of tests/test_kernels.py, then the models' widths (Hymba-1.5B
# di 3,200, Falcon-Mamba-7B 8,192) at ragged and full prompt lengths
SCAN_CASES = ([(1, 64, 256, 8), (2, 128, 512, 16), (1, 256, 256, 4)]
              + [(2, t, di, 16) for t in (1, 1000, 2048)
                 for di in (3200, 8192)])
# both kernels' edges (b, t, di, n, dt): T on, one below and one above
# the fused kernel's chunk (32 steps a shared buffer), half of it, the
# backward's 8-step chunk and v1's ring stage (4 steps); di not a
# multiple of any lanes option's channels a block (64, 32), of v1's plan
# nor of the backward's (48 at 3,000, 104 at 3,208), and di odd (dt and
# x copied 4 bytes at a time; v1's and the backward's scalar routes); N 1,
# 5, 8, 16; dt so large that every decay underflows to 0 (A bounded away
# from 0), dt 0 (every decay 1) everywhere and on every other step; B 1
# at Falcon-Mamba's width
SCAN_EDGES = ([(2, t, 3000, 16, "model") for t in (1, 3, 4, 5, 7, 8, 9,
                                                   15, 16, 17, 31, 32, 33)]
              + [(3, 70, 37, 16, "model"), (2, 40, 1000, 1, "model"),
                 (2, 40, 1000, 5, "model"), (2, 40, 1000, 8, "model"),
                 (2, 100, 1000, 16, "underflow"), (2, 100, 1000, 16, "zero"),
                 (2, 100, 1000, 16, "zero_odd_steps"),
                 (4, 48, 3208, 16, "model"), (1, 2048, 8192, 16, "model")])
SCAN_TOL = 1e-4                       # tests/test_kernels.py
# v1's launch options (channels a block, ring stages) run at every case
# whatever its plan picks: the fewest of each, a width no power of 2, the
# widest block
V1_OPTIONS = ((8, 1), (40, 2), (256, 3))
# the backward's channels a block run at every case whatever its plan
# picks: the fewest, 32, and the plans at Hymba's and Falcon-Mamba's
# widths
BWD_OPTIONS = (8, 32, 104, 128)


def fused_case(rng, b, t, di, n, dev, dt_mode: str = "model") -> tuple:
    """(dt, x, B, C, A) as a Mamba layer feeds the fused scan: dt > 0,
    A < 0, fp32.  ``dt_mode``: "underflow" makes dt 500 and |A| >= 0.5,
    so every decay is exp(<= -250) = 0; "zero" makes dt 0, so every decay
    is 1; "zero_odd_steps" zeroes dt on odd steps only."""
    dt = np.abs(rng.standard_normal((b, t, di))).astype(np.float32) * 0.1
    a = -np.abs(rng.standard_normal((di, n))).astype(np.float32)
    if dt_mode == "underflow":
        dt[:], a = 500.0, a - 0.5
    elif dt_mode == "zero":
        dt[:] = 0.0
    elif dt_mode == "zero_odd_steps":
        dt[:, 1::2] = 0.0
    return (torch.from_numpy(dt).to(dev),
            randn(rng, (b, t, di), torch.float32, dev),
            randn(rng, (b, t, n), torch.float32, dev) * 0.3,
            randn(rng, (b, t, n), torch.float32, dev),
            torch.from_numpy(a).to(dev))


def form_bx(dt, x, bm) -> torch.Tensor:
    """v1's bx formed outside the kernel, in the fused kernel's order."""
    return (dt * x)[..., None] * bm[:, :, None, :]


def fused_lanes(lanes: int):
    """The fused kernel launched with ``lanes`` lanes a channel whatever
    the wrapper would pick (counts nothing)."""
    def run(dt, x, bm, c, a):
        y = torch.empty_like(dt)
        fused_kernel.launch(fused_kernel.shape(dt.shape[0], dt.shape[2],
                                               lanes), dt, x, bm, c, a, y)
        return y
    return run


def v1_forced(channels: int, stages: int):
    """v1 launched with ``channels`` a block over ``stages`` whatever
    the wrapper would pick (counts nothing)."""
    def run(dt, bx, c, a):
        y = torch.empty_like(dt)
        scan_kernel.launch(scan_kernel.shape(dt.shape[0], dt.shape[2],
                                             channels, stages),
                           dt, bx, c, a, y)
        return y
    return run


def offset(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` starting one element into its storage
    (4 bytes past a 16-byte boundary for fp32)."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return out.view(t.shape).copy_(t)


def scan_errors(call, every_lanes: bool = False) -> dict:
    """A fused-scan call (dt, x, B, C, A) through both kernels and both
    plain versions: {check: (max abs error, within SCAN_TOL)}; with
    ``every_lanes``, the fused kernel also at each lanes-a-channel option
    and v1 at each of V1_OPTIONS and on its scalar route (bx offset by
    one float) against their plain versions."""
    dt, x, bm, c, a = call
    fused = fused_kernel.selective_scan_fused(*call)
    want = selective_scan_fused_ref(*call)
    out = {"fused_vs_plain": within(fused, want, SCAN_TOL)}
    if every_lanes:
        for lanes in fused_kernel.LANES:
            out[f"fused_lanes{lanes}_vs_plain"] = within(
                fused_lanes(lanes)(*call), want, SCAN_TOL)
    del want
    bx = form_bx(dt, x, bm)
    v1 = scan_kernel.selective_scan(dt, bx, c, a)
    v1_want = selective_scan_ref(dt, bx, c, a)
    out["v1_vs_plain"] = within(v1, v1_want, SCAN_TOL)
    out["fused_vs_v1"] = within(fused, v1, SCAN_TOL)
    if every_lanes:
        for ch, st in V1_OPTIONS:
            out[f"v1_{ch}x{st}_vs_plain"] = within(
                v1_forced(ch, st)(dt, bx, c, a), v1_want, SCAN_TOL)
        out["v1_scalar_vs_plain"] = within(
            scan_kernel.selective_scan(dt, offset(bx), c, a), v1_want,
            SCAN_TOL)
    return out


def scan_grads_autograd(dt, x, bm, c, a, dy) -> tuple:
    """The five gradients by autograd through ``ssm_scan_chunked``."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (dt, x, bm, c, a)]
        return torch.autograd.grad(ssm_scan_chunked(*ins), ins, dy)


def scan_bwd_errors(call, dy) -> dict:
    """The backward kernels on one call against
    ``selective_scan_fused_bwd_ref`` and autograd through
    ``ssm_scan_chunked``, each gradient relative to its largest, and a
    second launch on the same inputs bit for bit; the kernels also at
    each of BWD_OPTIONS channels a block and on the scalar route (dt, x
    and dy one float past a 16-byte boundary) against the plain
    backward."""
    got = fused_kernel.selective_scan_fused_bwd(*call, dy)
    again = fused_kernel.selective_scan_fused_bwd(*call, dy)
    names = ("ddt", "dx", "dB", "dC", "dA")
    want = selective_scan_fused_bwd_ref(*call, dy)
    errs = {f"{n}_vs_plain": card_rel_err(x, y) for n, x, y in zip(
        names, got, want)}
    errs.update({f"{n}_vs_autograd": card_rel_err(x, y) for n, x, y in zip(
        names, got, scan_grads_autograd(*call, dy))})
    dt = call[0]
    sms = fused_kernel.sm_count(dt.device)
    for ch in BWD_OPTIONS:
        p = fused_kernel.bwd_shape(dt.shape[0], dt.shape[2], ch, sms)
        errs.update({f"{n}_{ch}ch_vs_plain": card_rel_err(x, y)
                     for n, x, y in zip(names, fused_kernel.bwd_launch(
                         p, *call, dy), want)})
    scalar = fused_kernel.selective_scan_fused_bwd(
        offset(dt), offset(call[1]), *call[2:], offset(dy))
    errs.update({f"{n}_scalar_vs_plain": card_rel_err(x, y)
                 for n, x, y in zip(names, scalar, want)})
    return {"errors": errs, "ok": all(e <= SCAN_TOL for e in errs.values()),
            "bitwise_repeat": all(torch.equal(x, y)
                                  for x, y in zip(got, again))}


def phase_scan_kernels(dev) -> dict:
    """Both scan kernels' forward, and the fused scan's backward, at every
    case against their plain versions."""
    rng = np.random.default_rng(9)
    dy_rng = np.random.default_rng(19)
    sms = fused_kernel.sm_count(dev)
    out, backs = {}, {}
    for b, t, di, n, mode in ([s + ("model",) for s in SCAN_CASES]
                              + SCAN_EDGES):
        call = fused_case(rng, b, t, di, n, dev, mode)
        errs = scan_errors(call, every_lanes=True)
        back = scan_bwd_errors(call, randn(dy_rng, (b, t, di),
                                           torch.float32, dev))
        del call
        torch.cuda.synchronize()
        name = "x".join(map(str, (b, t, di, n))) + (
            "" if mode == "model" else f"_{mode}")
        out[name] = {k: {"max_abs_err": e, "ok": ok}
                     for k, (e, ok) in errs.items()}
        backs[name] = back
        out[name]["lanes"] = fused_kernel.plan(b, di, sms).lanes
        v1_plan = scan_kernel.plan(b, di, sms)
        out[name]["v1_plan"] = [v1_plan.channels, v1_plan.stages]
    emit(phase9_backward=backs)         # before its checks
    for name, r in out.items():
        for k, v in r.items():
            if k not in ("lanes", "v1_plan"):
                check(v["ok"], f"phase 9 {name} {k}: within {SCAN_TOL}")
    for name, r in backs.items():
        check(r["ok"], f"phase 9 {name}: the five gradients within "
              f"{SCAN_TOL} of the plain backward and of autograd")
        check(r["bitwise_repeat"], f"phase 9 {name}: a second backward "
              "launch gives the same bits")
    return out


# ----------------------------------------------------------------------
# phases 10 and 11: the model's prefill and serve steps
# ----------------------------------------------------------------------
# (model, layers in phase 10, prompts x tokens of phase 10's prefill)
MODEL_IDENTITY = [("falcon-mamba-7b", 2, 2, 300),
                  ("hymba-1.5b", 3, 2, 1100)]   # past the 1,024 window
IDENTITY_PROMPT, IDENTITY_NEW = 24, 8
MODEL_MAIN = ["falcon-mamba-7b", "hymba-1.5b"]
MAIN_BATCH, MAIN_PREFILL = 4, 2048
MAIN_PROMPT, MAIN_NEW = 64, 64
BUSY_STEPS = 16               # decode steps profiled for the busy share


def reset_model_launches() -> None:
    for mod in (scan_kernel, fused_kernel, flash_kernel, paged_kernel,
                kernel):
        mod.reset_launches()


def model_launches() -> dict:
    return {**scan_kernel.launches, **fused_kernel.launches,
            **flash_kernel.launches, **paged_kernel.launches,
            **kernel.launches}


def device_ops(fn) -> list:
    """Device time of everything ``fn`` launches (kernels, copies, fills)
    from ``torch.profiler``'s CUDA activity, by operation: [(name, total
    ms, count)], the largest first; on one stream nothing overlaps."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [(ev.key, getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0.0)) / 1e3,
            ev.count) for ev in prof.key_averages()]
    return sorted((o for o in ops if o[1] > 0), key=lambda o: -o[1])


def device_busy_ms(fn) -> float:
    """The sum of ``device_ops``, in ms (0.0 when the profiler records no
    device time)."""
    return sum(ms for _, ms, _ in device_ops(fn))


def expected_windows(cfg) -> list:
    """The window each flash launch of one prefill must carry, layer by
    layer: None on a full-attention layer."""
    w = layer_windows(cfg)
    return [] if w is None else [int(v) or None for v in w]


class ModelRecorder:
    """Wraps the model's calls into the fused scan, flash attention,
    ``layers.cross_attention`` and the MoE's ``moe_route`` and
    ``moe_slots``.  Keeps a copy of the scan calls whose index is in
    ``keep``.  Of every flash call it records the window (``windows``) and
    counts the kind (``self`` causal, ``cross`` inside cross-attention,
    ``encoder`` the other non-causal calls) and the signature (kind, Sq,
    Skv, window); it keeps a copy (q, k, v, causal, window) of the causal
    calls whose index is in ``keep_flash``, with ``per_signature`` of the
    first call of each signature, and with ``keep_kv`` the k and v of
    every causal call, uncopied (the decoder's context, layer by layer).
    Of every MoE call it sums on the device the pairs dropped and the
    tokens dropped whole (every one of their k pairs); with ``routes`` it
    keeps the experts and kept slots on the host."""

    def __init__(self, keep=(), keep_flash=(), per_signature=False,
                 keep_kv=False, routes=False):
        self.keep, self.seen = set(keep), 0
        self.keep_flash = set(keep_flash)
        self.per_signature, self.keep_kv = per_signature, keep_kv
        self.routes = routes
        self.scans, self.flashes, self.calls, self.kv = [], [], {}, []
        self._cross = False
        self._orig = (scan_ops.selective_scan_fused,
                      flash_ops.flash_attention, L.cross_attention,
                      L.moe_route, L.moe_slots)
        self.reset()

    def reset(self) -> None:
        """Zero the counts; the kept calls stay."""
        self.windows = []
        self.kinds = {"self": 0, "encoder": 0, "cross": 0}
        self.signatures = {}
        self.experts, self.kept = [], []
        self.pairs, self.dropped, self.tokens_dropped = 0, 0, 0

    def scan(self, dt, x, bm, c, a):
        if self.seen in self.keep:
            self.scans.append(tuple(t.clone() for t in (dt, x, bm, c, a)))
        self.seen += 1
        return self._orig[0](dt, x, bm, c, a)

    def flash(self, q, k, v, causal=True, window=None):
        kind = "self" if causal else "cross" if self._cross else "encoder"
        sig = (kind, q.shape[2], k.shape[2], window)
        if causal and len(self.windows) in self.keep_flash:
            self.flashes.append(tuple(t.clone() for t in (q, k, v))
                                + (causal, window))
        if self.per_signature and sig not in self.calls:
            self.calls[sig] = tuple(t.clone() for t in (q, k, v)) \
                + (causal, window)
        if self.keep_kv and causal:
            self.kv.append((k, v))
        self.windows.append(window)
        self.kinds[kind] += 1
        self.signatures[sig] = self.signatures.get(sig, 0) + 1
        return self._orig[1](q, k, v, causal, window)

    def cross_attention(self, *args):
        self._cross = True
        try:
            return self._orig[2](*args)
        finally:
            self._cross = False

    def moe_route(self, *args):
        top_w, top_e = self._orig[3](*args)
        if self.routes:
            self.experts.append(top_e.cpu())
        return top_w, top_e

    def moe_slots(self, top_e, *args):
        pos, keep = self._orig[4](top_e, *args)
        if self.routes:
            self.kept.append(keep.cpu())
        self.dropped = self.dropped + (~keep).sum()
        self.tokens_dropped = self.tokens_dropped + (
            ~keep.reshape(top_e.shape).any(-1)).sum()
        self.pairs += keep.numel()
        return pos, keep

    def signature_counts(self) -> dict:
        return {"/".join(map(str, sig)): n
                for sig, n in self.signatures.items()}

    def __enter__(self):
        (scan_ops.selective_scan_fused, flash_ops.flash_attention,
         L.cross_attention, L.moe_route, L.moe_slots) = (
            self.scan, self.flash, self.cross_attention, self.moe_route,
            self.moe_slots)
        return self

    def __exit__(self, *exc):
        (scan_ops.selective_scan_fused, flash_ops.flash_attention,
         L.cross_attention, L.moe_route, L.moe_slots) = self._orig


def serve(cfg, model, prompt: np.ndarray, new: int, dev,
          keep_logits, max_len: int = None, cache_dtype=None,
          cross=None, caches=None, start: int = 0):
    """make_serve_step over B sequences: teacher-force ``prompt`` [B, P],
    then ``new`` greedy tokens, from position ``start`` of ``caches``
    (written in place) or, by default, of ``init_caches`` of ``max_len``
    positions (default P + new), cast to ``cache_dtype`` if given, an
    encdec model's ``cross_k``/``cross_v`` set to ``cross`` (its
    ``encoder_kv``).  ``keep_logits`` True keeps each step's logits [B, V]
    on the host, an int the logits of that step only, on the device.
    Returns (tokens fed [B, P + new - 1], tokens generated [B, new], the
    kept logits or None, non-finite logits counted on the device,
    steps)."""
    step = make_serve_step(cfg)
    b, p = prompt.shape
    if caches is None:
        caches = init_caches(cfg, b, max_len or p + new, device=dev)
        if cross is not None:
            caches["cross_k"], caches["cross_v"] = cross
        if cache_dtype is not None:
            caches = {k: v.to(cache_dtype) for k, v in caches.items()}
    prompt = torch.from_numpy(prompt).to(dev)
    nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
    fed, gen, logs, tok = [], [], [], None
    for t in range(p + new - 1):
        if t < p:
            tok = prompt[:, t:t + 1]
        fed.append(tok)
        tok, logits, caches = step(
            model, tok,
            torch.full((b,), start + t, dtype=torch.int32, device=dev),
            caches)
        nonfinite.add_((~torch.isfinite(logits)).sum())
        if t >= p - 1:
            gen.append(tok)
        if keep_logits is True:
            logs.append(logits[:, 0].float().cpu())
        elif keep_logits is not False and t == keep_logits:
            logs.append(logits[:, 0].clone())
    return (torch.cat(fed, 1), torch.cat(gen, 1), logs or None, nonfinite,
            p + new - 1)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| relative to the largest |want| (absolute where
    ``want`` is all zeros)."""
    g, w = got.float().cpu(), want.float().cpu()
    scale = float(w.abs().max())
    return float((g - w).abs().max()) / (scale or 1.0)


def phase_model_identity(card_dev: str = "cuda") -> dict:
    out = {}
    for name, layers, b, t in MODEL_IDENTITY:
        cfg = dataclasses.replace(get_config(name), num_layers=layers)
        model = init_model(cfg, seed=0, device="cpu", dtype=torch.float32)
        rng = np.random.default_rng(10)
        long = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
        short = rng.integers(0, cfg.vocab_size,
                             (b, IDENTITY_PROMPT)).astype(np.int32)
        runs = {}
        for dev in (card_dev, "cpu"):
            m = copy.deepcopy(model).to(dev) if dev == card_dev else model
            reset_model_launches()
            with ModelRecorder() as rec:
                t0 = time.perf_counter()
                nxt = make_prefill_step(cfg)(
                    m, {"tokens": torch.from_numpy(long).to(dev)})
                fed, gen, logs, nonfinite, _ = serve(
                    cfg, m, short, IDENTITY_NEW, dev, keep_logits=True)
                runs[dev] = {"prefill": nxt.float().cpu(), "fed": fed,
                             "gen": gen.cpu(), "decode": logs,
                             "nonfinite": int(nonfinite)}
                if dev == card_dev:
                    # the kernel's logits at every position of the served
                    # sequence, against the decode's recurrence
                    with torch.no_grad():
                        runs[dev]["full"] = forward(
                            cfg, m, {"tokens": fed}).float().cpu()
                torch.cuda.synchronize()
                runs[dev]["wall_s"] = time.perf_counter() - t0
                runs[dev]["launches"] = model_launches()
                runs[dev]["windows"] = rec.windows
            del m
        torch.cuda.empty_cache()
        card, cpu = runs[card_dev], runs["cpu"]
        dec = torch.stack(card["decode"], 1)              # [B, S, V]
        full = card["full"]
        # Hymba's decode sees the whole context on its window layers (the
        # reference's ring-buffer test): compare inside the window only
        inside = min(dec.shape[1], cfg.sliding_window or dec.shape[1])
        err, ok = within(dec[:, :inside], full[:, :inside], 3e-2)
        prefill_calls = 2
        want = {"selective_scan_fused": layers * prefill_calls,
                "flash_attention": (layers * prefill_calls
                                    if cfg.has_attention else 0)}
        r = {"layers": layers, "prefill_tokens": [b, t],
             "serve": [b, IDENTITY_PROMPT, IDENTITY_NEW],
             "prefill_rel_err": rel_err(card["prefill"], cpu["prefill"]),
             "decode_rel_err": max(rel_err(g, c) for g, c in
                                   zip(card["decode"], cpu["decode"])),
             "tokens_identical": bool(torch.equal(card["gen"], cpu["gen"])),
             "decode_vs_prefill_max_abs_err": err,
             "decode_vs_prefill_rel_err": rel_err(dec[:, :inside],
                                                  full[:, :inside]),
             "positions_compared": inside,
             "launches": {d: r_["launches"] for d, r_ in runs.items()},
             "wall_s": {d: r_["wall_s"] for d, r_ in runs.items()}}
        out[name] = r
        check(r["prefill_rel_err"] <= 1e-4,
              f"phase 10 {name}: card prefill logits within 1e-4 of the "
              "CPU's")
        check(r["tokens_identical"],
              f"phase 10 {name}: card and CPU greedy tokens identical")
        check(ok, f"phase 10 {name}: card prefill and decode logits within "
              "3e-2")
        check(card["nonfinite"] == cpu["nonfinite"] == 0,
              f"phase 10 {name}: finite logits")
        launched = card["launches"]
        check(all(launched[k] == n for k, n in want.items())
              and launched["selective_scan"] == 0,
              f"phase 10 {name}: one scan (and flash) launch per layer of "
              "each prefill on the card")
        check(card["windows"] == expected_windows(cfg) * prefill_calls,
              f"phase 10 {name}: flash windows as layer_windows gives")
        check(not any(cpu["launches"].values()),
              f"phase 10 {name}: the CPU run launched no kernel")
    return out


def main_inputs(cfg) -> tuple:
    """Phase 11's seeded tokens: the prefill's [MAIN_BATCH, MAIN_PREFILL]
    (a tensor) and the served prompts' [MAIN_BATCH, MAIN_PROMPT]."""
    rng = np.random.default_rng(11)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MAIN_BATCH, MAIN_PREFILL)).astype(np.int32))
    short = rng.integers(0, cfg.vocab_size,
                         (MAIN_BATCH, MAIN_PROMPT)).astype(np.int32)
    return prompts, short


TOP_OPS = 8                   # device operations of a prefill listed


def phase_busy_share(model_out: dict, dev: str = "cuda") -> dict:
    """The device's busy share of phase 11's prefill and decode: each
    model made again (same seed), one prefill and BUSY_STEPS decode steps
    under the profiler, their device time over phase 11's unprofiled wall
    time; the prefill's device time split by operation (the TOP_OPS
    largest, and the fused scan's and flash's share of it).  It runs
    last: after traces this large, later profiler traces in the process
    missed their first kernels (phase 12's device times)."""
    out = {}
    for name, o in model_out.items():
        cfg = get_config(name)
        model = init_model(cfg, seed=0, device=dev)
        prompts, short = main_inputs(cfg)
        ops = device_ops(lambda: make_prefill_step(cfg)(
            model, {"tokens": prompts.to(dev)}))
        prefill_dev = sum(ms for _, ms, _ in ops)
        step_dev = device_busy_ms(lambda: serve(
            cfg, model, short[:, :8], BUSY_STEPS - 7, dev,
            keep_logits=False)) / BUSY_STEPS
        d, pre = o["decode"], o["prefill"]

        def share(symbol):
            hits = [(ms, n) for key, ms, n in ops if symbol in key]
            return {"device_ms": sum(ms for ms, _ in hits),
                    "launches": sum(n for _, n in hits),
                    "share": sum(ms for ms, _ in hits) / prefill_dev}
        out[name] = {
            "prefill_device_ms": prefill_dev,
            "prefill_busy_share": prefill_dev / (1e3 * pre["seconds"]),
            "prefill_top_ops": [{"op": key[:120], "device_ms": ms,
                                 "count": n, "share": ms / prefill_dev}
                                for key, ms, n in ops[:TOP_OPS]],
            "prefill_fused_scan": share("selective_scan_fused_kernel"),
            "prefill_flash": share("flash_fwd"),
            "decode_device_ms_per_step": step_dev,
            "decode_wall_ms_per_step": 1e3 * d["seconds"] / d["steps"],
            "decode_busy_share": step_dev * d["steps"] / (1e3 * d["seconds"])}
        check(out[name]["prefill_fused_scan"]["launches"] == cfg.num_layers,
              f"phase 11 {name}: the profiled prefill shows one fused-scan "
              "launch a layer")
        del model
        torch.cuda.empty_cache()
    return out


def flash_picks(cfg, seed: int = 13) -> list:
    """Phase 12's flash calls of one prefill: one full-attention layer and
    two sliding-window layers, each drawn uniformly from its kind (none
    when the model has no attention)."""
    windows = expected_windows(cfg)
    rng = np.random.default_rng(seed)
    pick = []
    for layers, n in (([i for i, w in enumerate(windows) if w is None], 1),
                      ([i for i, w in enumerate(windows) if w], 2)):
        if layers:
            pick += rng.choice(layers, min(n, len(layers)),
                               replace=False).tolist()
    return sorted(pick)


def phase_model_main(name: str, dev: str = "cuda", keep: int = 3):
    """The serving path of one model at full size, bf16 random weights made
    on the card: make_prefill_step on MAIN_BATCH prompts of MAIN_PREFILL
    tokens, then make_serve_step on MAIN_BATCH sequences (MAIN_PROMPT
    teacher-forced, MAIN_NEW generated).  ``keep`` fused-scan calls,
    picked uniformly from the prefill's, and the flash calls of
    ``flash_picks`` are kept for phase 12."""
    cfg = get_config(name)
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    prompts, short = main_inputs(cfg)
    pick = sorted(np.random.default_rng(12).choice(
        cfg.num_layers, keep, replace=False).tolist())
    flash_pick = flash_picks(cfg)
    torch.cuda.reset_peak_memory_stats()
    with ModelRecorder(pick, flash_pick) as rec:
        reset_model_launches()
        t0 = time.perf_counter()
        logits = make_prefill_step(cfg)(model,
                                        {"tokens": prompts.to(dev)})
        nonfinite = int((~torch.isfinite(logits)).sum())
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_launches = model_launches()
        prefill_variants = dict(flash_kernel.variant_launches)
        del logits
        reset_model_launches()
        t0 = time.perf_counter()
        _, gen, _, dec_nonfinite, steps = serve(cfg, model, short, MAIN_NEW,
                                                dev, keep_logits=False)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        decode_launches = model_launches()
    expected = {"selective_scan_fused": cfg.num_layers,
                "flash_attention": (cfg.num_layers if cfg.has_attention
                                    else 0)}
    windows = expected_windows(cfg)
    out = {
        "model": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "d_inner": cfg.d_inner_, "ssm_state": cfg.ssm_state,
        "params": sum(p.numel() for p in model.parameters()),
        "load_s": load_s,
        "prefill": {"batch": MAIN_BATCH, "tokens": MAIN_PREFILL,
                    "seconds": prefill_s,
                    "tokens_per_s": MAIN_BATCH * MAIN_PREFILL / prefill_s,
                    "launches": prefill_launches,
                    "flash_variants": prefill_variants,
                    "windowed_flash": sum(w is not None
                                          for w in rec.windows)},
        "decode": {"batch": MAIN_BATCH, "prompt": MAIN_PROMPT,
                   "new": MAIN_NEW, "steps": steps, "seconds": decode_s,
                   "tokens_per_s": MAIN_BATCH * steps / decode_s,
                   "new_tokens": int(gen.numel()),
                   "launches": decode_launches},
        "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
        "nonfinite_logits": nonfinite + int(dec_nonfinite),
        "expected_launches": expected}
    check(all(prefill_launches[k] == n for k, n in expected.items())
          and sum(prefill_launches.values()) == sum(expected.values()),
          f"phase 11 {name}: one fused scan (and flash) launch per layer of "
          "the prefill, nothing else")
    check(prefill_variants == {
              "mma": expected["flash_attention"], "simt": 0},
          f"phase 11 {name}: every bf16 flash launch of the prefill on the "
          "tensor-core kernel")
    check(rec.windows == windows,
          f"phase 11 {name}: flash windows on exactly the layers "
          "layer_windows gives one")
    check(not any(decode_launches.values()),
          f"phase 11 {name}: decode launched no kernel")
    check(gen.shape == (MAIN_BATCH, MAIN_NEW),
          f"phase 11 {name}: every sequence generated its tokens")
    check(out["nonfinite_logits"] == 0, f"phase 11 {name}: finite logits")
    check(len(rec.scans) == keep and len(rec.flashes) == len(flash_pick),
          f"phase 11 {name}: scan and flash calls kept")
    out["flash_layers_kept"] = flash_pick
    del model
    torch.cuda.empty_cache()
    return out, rec.scans, rec.flashes


# ----------------------------------------------------------------------
# phase 12: the captured scan calls, again and timed
# ----------------------------------------------------------------------
SCAN_FLOPS = 6                 # exp argument, decay, dt*x*B, h, h*c, sum
SFU_PER_CLOCK = 16             # exponentials an SM returns a clock (cc 9.0)
SCAN_SOURCE = scan_kernel.SOURCE


def max_sm_hz() -> float:
    """The card's maximum SM clock, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def scan_sfu_bound(call, sfu_per_s: float) -> float:
    """Seconds the special-function units take for the scan's one
    exponential a (t, d, n) (both kernels), at ``sfu_per_s``: SMs x
    SFU_PER_CLOCK x the maximum SM clock."""
    dt, a = call[0], call[4]
    return dt.numel() * a.shape[1] / sfu_per_s


def scan_bound(call, v1: bool) -> tuple:
    """(bytes / HBM rate, flops / CUDA-core rate) in seconds: inputs read
    once (dt, x, B, C, A for the fused kernel; dt, bx, C, A for v1), y
    written once; SCAN_FLOPS per (t, d, n)."""
    dt, x, bm, c, a = call
    b, t, di = dt.shape
    n = a.shape[1]
    per_td = 2 + (n if v1 else 1)              # dt, y, then x or bx
    nbytes = 4 * (b * t * di * per_td + b * t * n * (1 if v1 else 2)
                  + di * n)
    return nbytes / HBM_BYTES_PER_S, \
        SCAN_FLOPS * b * t * di * n / CUDA_CORE_OPS_PER_S


def bracketed_ms(fn, calls, reps: int) -> float:
    """Mean device time of one launch from CUDA events recorded on the
    stream just before and just after it.  The same call is launched
    first, so the card is still busy with it while the host queues the
    events and the timed launch (a few tens of µs against a kernel of
    0.5 ms or more): the events bracket the kernel alone.  (The
    profiler's CUDA activity, which phases 4 and 8 read, came back without
    the scan kernels' launches in whole-script runs.)"""
    pairs = []
    for _ in range(reps):
        for c in calls:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            fn(*c)
            start.record()
            fn(*c)
            end.record()
            pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.mean([s.elapsed_time(e) for s, e in pairs]))


def v1_args(call) -> tuple:
    dt, x, bm, c, a = call
    return dt, form_bx(dt, x, bm), c, a


def phase_scan_captured(calls: dict, launched: dict) -> list:
    """Each kept fused-scan call of phase 11 (by model) through kernel and
    plain version, compared and timed; v1 on the same calls with bx formed
    outside (one call's bx at a time, the forming not timed)."""
    flat = [c for cs in calls.values() for c in cs]
    worst = {"selective_scan_fused": 0.0, "selective_scan": 0.0}
    for call in flat:
        errs = scan_errors(call)
        for k, (e, ok) in errs.items():
            check(ok, f"phase 12 {k} within {SCAN_TOL} on a captured call")
        worst["selective_scan_fused"] = max(worst["selective_scan_fused"],
                                            errs["fused_vs_plain"][0])
        worst["selective_scan"] = max(worst["selective_scan"],
                                      errs["v1_vs_plain"][0])
    v1_ms, v1_plain, v1_dev = [], [], []
    for call in flat:
        args = v1_args(call)
        v1_ms.append(cuda_ms(scan_kernel.selective_scan, [args], 10))
        v1_plain.append(cuda_ms(selective_scan_ref, [args], 1))
        v1_dev.append(bracketed_ms(scan_kernel.selective_scan, [args], 5))
        del args
    sfu_per_s = (fused_kernel.sm_count(flat[0][0].device) * SFU_PER_CLOCK
                 * max_sm_hz())
    t_sfu = np.array([scan_sfu_bound(c, sfu_per_s) for c in flat])
    kernels = []
    for name, v1 in (("selective_scan", True),
                     ("selective_scan_fused", False)):
        t_bytes, t_ops = zip(*(scan_bound(c, v1) for c in flat))
        row = {"name": name, "route": "cuda",
               "source": str(SCAN_SOURCE.relative_to(ROOT)),
               "replaces": REPLACES[name], "launches": launched[name],
               "max_abs_err": worst[name], "dtype": "float32",
               "bound_ms": 1e3 * float(np.mean(np.maximum(t_bytes, t_ops))),
               "bound_by": ("bytes" if np.mean(t_bytes) >= np.mean(t_ops)
                            else "operations"),
               "bound_sfu_ms": 1e3 * float(np.mean(t_sfu)),
               "library_ms": None,
               "timed_calls": len(flat),
               "calls_by_model": {m: len(cs) for m, cs in calls.items()},
               "shapes": sorted({tuple(c[0].shape) + (c[4].shape[1],)
                                 for c in flat})}
        if v1:
            row.update(ms=float(np.mean(v1_ms)),
                       plain_ms=float(np.mean(v1_plain)),
                       on_main_path=False)
        else:
            row.update(ms=cuda_ms(fused_kernel.selective_scan_fused, flat,
                                  10),
                       plain_ms=cuda_ms(selective_scan_fused_ref, flat, 1),
                       on_main_path=True)
        # the same per model: each model's calls share one shape
        row["by_model"], i = {}, 0
        for model, cs in calls.items():
            part = slice(i, i + len(cs))
            i += len(cs)
            if v1:
                ms = float(np.mean(v1_ms[part]))
                dev_ms = float(np.mean(v1_dev[part]))
            else:
                ms = cuda_ms(fused_kernel.selective_scan_fused, cs, 10)
                dev_ms = bracketed_ms(fused_kernel.selective_scan_fused, cs,
                                      5)
            b, _, di = cs[0][0].shape
            sms = fused_kernel.sm_count(cs[0][0].device)
            v1_plan = scan_kernel.plan(b, di, sms)
            row["by_model"][model] = {
                "shape": list(cs[0][0].shape) + [cs[0][4].shape[1]],
                **({"channels": v1_plan.channels, "stages": v1_plan.stages,
                    "busiest_sm_over_mean": scan_kernel.busiest_sm(
                        b, di, v1_plan.channels, sms) / (b * di / sms)}
                   if v1 else
                   {"lanes": fused_kernel.plan(b, di, sms).lanes}),
                "ms": ms, "device_ms": dev_ms,
                "bound_ms": 1e3 * float(np.mean(np.maximum(
                    t_bytes[part], t_ops[part]))),
                "bound_sfu_ms": 1e3 * float(np.mean(t_sfu[part]))}
        # every model times the same number of calls
        row["device_ms"] = float(np.mean(
            [m["device_ms"] for m in row["by_model"].values()]))
        kernels.append(row)
    return kernels


def flash_any(q, k, v, causal, window):
    return flash_kernel.flash_attention_fwd(q, k, v, causal=causal,
                                            window=window)


def flash_plain(q, k, v, causal, window):
    return attention_plain(q, k, v, causal=causal, window=window)


def flash_simt(q, k, v, causal, window):
    """The CUDA-core kernel on a call the wrapper gives the tensor-core
    kernel, timed beside it (counts nothing)."""
    out = torch.empty_like(q)
    flash_kernel.launch("simt", q, k, v, out, causal, window)
    return out


def phase_flash_captured(calls: dict, launched: dict) -> dict:
    """Each kept flash call of phase 11 (by model) through the kernel and
    its plain version, compared at the dtype's tolerance, and timed beside
    its bound and scaled_dot_product_attention: one ``by_model`` entry of
    the flash row per model with attention."""
    gqa = sdpa_gqa()
    out = {}
    for model, cs in calls.items():
        if not cs:
            continue
        dtype = cs[0][0].dtype
        worst, lib_worst = 0.0, 0.0
        lib = [flash_library(c, gqa) for c in cs]
        for c, (lib_fn, lib_args) in zip(cs, lib):
            want = flash_plain(*c)
            err, ok = within(flash_any(*c), want, TOL[dtype])
            check(ok, f"phase 12 {model} flash (window {c[4]}) within "
                  f"{TOL[dtype]} of plain on a captured call")
            worst = max(worst, err)
            lib_worst = max(lib_worst, within(lib_fn(*lib_args), want,
                                              TOL[dtype])[0])
            del want
        t_bytes, t_ops = zip(*(flash_bound(c) for c in cs))
        kind = flash_kernel.variant(dtype, cs[0][0].shape[3])
        out[model] = {
            "shape": list(cs[0][0].shape) + [cs[0][1].shape[1]],
            "dtype": str(dtype).split(".")[1], "variant": kind,
            "windows": [c[4] for c in cs], "launches": launched[model],
            "timed_calls": len(cs), "max_abs_err": worst,
            "ms": cuda_ms(flash_any, cs, 10),
            "device_ms": bracketed_ms(flash_any, cs, 5),
            "plain_ms": cuda_ms(flash_plain, cs, 2),
            "simt_ms": (cuda_ms(flash_simt, cs, 3) if kind != "simt"
                        else None),
            "library_ms": cuda_ms(lib[0][0], [a for _, a in lib], 10),
            "library_max_abs_err": lib_worst,
            "bound_ms": 1e3 * float(np.mean(np.maximum(t_bytes, t_ops))),
            "bound_by": ("bytes" if np.mean(t_bytes) >= np.mean(t_ops)
                         else "operations")}
        del lib
        torch.cuda.empty_cache()
    return out


def merge_flash(kernels: list, by_model: dict, variants: dict) -> None:
    """Give phase 8's flash row (the serving engine's Qwen3-1.7B calls) a
    ``by_model`` entry per model, phase 12's beside it; its launches count
    every main path the kernel ran on.  No-op without phase 8's row."""
    for row in kernels:
        if row["name"] == "flash_attention":
            row["by_model"] = {"qwen3-1.7b": {
                k: row[k] for k in (
                    "dtype", "launches", "timed_calls", "max_abs_err", "ms",
                    "device_ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by", "mean_prompt")}, **by_model}
            row["launches"] += sum(m["launches"] for m in by_model.values())
            for v in variants.values():
                for kind, n in v.items():
                    row["launches_by_variant"][kind] += n


# ----------------------------------------------------------------------
# phases 13 and 14: training
# ----------------------------------------------------------------------
# (model, layers, tokens a sequence in phase 13): Qwen3's and
# Falcon-Mamba's cut from 256 to 128 for the script's time limit (their
# CPU steps took 66 of the phase's ~200 s); Hymba's, whose AdamW update is
# held too, stays at 256 (at 128 one element's masters cancel to where one
# fp32 step is two bf16 steps: ROADMAP §3).  TRAIN_BATCH x TRAIN_SEQ is
# also phases 15 and 19's batch
TRAIN_IDENTITY = [("qwen3-1.7b", 2, 128), ("falcon-mamba-7b", 2, 128),
                  ("hymba-1.5b", 3, 256)]
TRAIN_BATCH, TRAIN_SEQ = 2, 256
TRAIN_TC = TrainConfig(total_steps=10, warmup_steps=2)
TRAIN_TOL = 1e-4
# phase 14: Hymba-1.5B at full width and depth
TRAIN_MAIN = "hymba-1.5b"
TRAIN_MAIN_BATCH, TRAIN_MAIN_SEQ, TRAIN_MAIN_STEPS = 4, 2048, 6
GEMM_KERNELS = ("gemm", "xmma", "nvjet", "cutlass", "cublas")


def kernel_layers(cfg) -> dict:
    """Layers whose forward launches each kernel once."""
    return {"flash_attention": cfg.num_layers if cfg.has_attention else 0,
            "selective_scan_fused": cfg.num_layers if cfg.has_ssm else 0}


def train_launches(cfg, steps: int, accum: int, remat: bool = True) -> dict:
    """Each kernel's launches in ``steps`` train steps: the forward kernel
    once per layer of each micro-batch's forward and again in its
    recompute under remat; the backward kernels (``<kernel>_bwd``, one
    launch of their wrapper) once per layer of each micro-batch, from the
    Functions' backwards."""
    layers = kernel_layers(cfg)
    return {**{k: n * steps * accum * (1 + remat) for k, n in layers.items()},
            **{f"{k}_bwd": n * steps * accum for k, n in layers.items()}}


def state_to(state: dict, dev) -> dict:
    """A copy of a train state on ``dev``."""
    opt = state["opt"]
    return {"model": copy.deepcopy(state["model"]).to(dev),
            "opt": adamw.OptState(
                step=opt.step.to(dev, copy=True),
                **{f: {n: t.to(dev, copy=True)
                       for n, t in getattr(opt, f).items()}
                   for f in ("master", "mu", "nu")})}


def train_run(cfg, base: dict, batch: dict, accum: int, dev,
              second: bool) -> tuple:
    """One train step from a copy of ``base`` on ``dev``, the launch
    counts zeroed just before and read just after; with ``second``, then
    a second step (on the bf16 parameters the first left, A_log and D
    included, which the fused kernel takes widened to fp32).  Returns (host copies of the moments, masters and
    parameters after the first step; a record)."""
    state = state_to(base, dev)
    b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    step = make_train_step(cfg, TRAIN_TC, ParallelConfig(grad_accum=accum))
    reset_model_launches()
    t0 = time.perf_counter()
    state, m = step(state, b)
    loss = float(m["loss"])
    seconds = time.perf_counter() - t0
    rec = {"metrics": {"loss": loss, "grad_norm": float(m["grad_norm"]),
                       "lr": float(m["lr"])},
           "seconds": seconds, "launches": model_launches(),
           "flash_variants": dict(flash_kernel.variant_launches),
           "flash_bwd_variants": dict(flash_kernel.bwd_variant_launches)}
    first = {f: {n: t.detach().to("cpu", copy=True) for n, t in
                 getattr(state["opt"], f).items()}
             for f in ("master", "mu", "nu")}
    first["params"] = {n: p.detach().to("cpu", copy=True)
                       for n, p in state["model"].named_parameters()}
    if second:
        state, m2 = step(state, b)
        rec["loss2"] = float(m2["loss"])
    rec["param_dtypes"] = sorted({str(p.dtype) for p in
                                  state["model"].parameters()})
    return first, rec


def adamw_identity(base: dict, grads: dict, dev) -> dict:
    """``adamw.update`` on the same state and gradients on the card and on
    the CPU: masters and moments within TRAIN_TOL of each tensor's
    largest, parameters bf16 within one step of each other."""
    out = {}
    for d in (dev, "cpu"):
        st = state_to(base, d)
        params, opt, m = adamw.update({n: g.to(d) for n, g in grads.items()},
                                      st["opt"], TRAIN_TC)
        out[d] = (params, opt, {k: float(v) for k, v in m.items()})
    (pc, oc, mc), (pp, op, mp) = out[dev], out["cpu"]
    err = max(rel_err(getattr(oc, f)[n], getattr(op, f)[n])
              for f in ("master", "mu", "nu") for n in grads)
    ulps = max(int((pc[n].cpu().view(torch.int16).int()
                    - pp[n].view(torch.int16).int()).abs().max())
               for n in grads)
    return {"max_rel_err": err, "param_bf16_steps": ulps,
            "grad_norm_rel_err": abs(mc["grad_norm"] - mp["grad_norm"])
            / mp["grad_norm"], "lr_equal": mc["lr"] == mp["lr"]}


def ckpt_round_trip(cfg, state: dict, dev) -> dict:
    """Save a card state, restore it into a fresh state's structure on the
    card: every leaf in the fresh dtype and equal to the saved one
    widened."""
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        ckpt.save(state, 1, d)
        got, step = ckpt.restore(state_shapes(cfg), d, device=dev)
        nbytes = sum(f.stat().st_size for f in Path(d).rglob("*")
                     if f.is_file())
    fresh = state_shapes(cfg)
    pairs = [(p, q, f) for (_, p), (_, q), (_, f) in zip(
        got["model"].named_parameters(), state["model"].named_parameters(),
        fresh["model"].named_parameters())]
    for fld in ("master", "mu", "nu"):
        pairs += [(getattr(got["opt"], fld)[n], t, t)
                  for n, t in getattr(state["opt"], fld).items()]
    pairs.append((got["opt"].step, state["opt"].step, state["opt"].step))
    return {"step": step, "leaves": len(pairs), "bytes": nbytes,
            "dtypes_fresh": all(p.dtype == f.dtype for p, _, f in pairs),
            "on_card": all(p.device.type == "cuda" for p, _, _ in pairs),
            "equal": all(torch.equal(p.double(), q.double())
                         for p, q, _ in pairs),
            "a_log_dtype": str(got["model"].layers[0].ssm.A_log.dtype)
            if cfg.has_ssm else None}


def phase_train_identity(card_dev: str = "cuda") -> dict:
    """Phase 13: make_train_step on the card at grad_accum 1 and 2, each
    held against one step on the CPU at grad_accum 1, fp32 from one
    seeded init_model, remat on (each model's record printed before its
    checks); the optimizer alone on both devices; train_loop killed and
    resumed on the card, and a checkpoint round trip of the state it
    ends with."""
    out = {}
    b1 = TRAIN_TC.beta1
    pending = []

    def defer(cond: bool, what: str) -> None:
        pending.append((cond, what))
    for name, layers, seq in TRAIN_IDENTITY:
        cfg = dataclasses.replace(get_config(name), num_layers=layers)
        base = init_state(cfg, seed=0, device="cpu", dtype=torch.float32)
        batch = SyntheticLM(cfg.vocab_size, TRAIN_BATCH, seq,
                            seed=13).batch_at(0)
        r = {"layers": layers, "batch": [TRAIN_BATCH, seq],
             "params": sum(p.numel() for p in base["model"].parameters())}
        # one CPU oracle a model, the full batch in one micro-batch: both
        # card runs are held against it (accumulating over micro-batches
        # changes the order of fp32 sums only)
        t0 = time.perf_counter()
        cpu, cpu_rec = train_run(cfg, base, batch, 1, "cpu", False)
        cpu_rec["run_s"] = time.perf_counter() - t0
        cpu_rec["grad_accum"] = 1
        r["cpu"] = cpu_rec
        for accum in (1, 2):
            t0 = time.perf_counter()
            card, card_rec = train_run(cfg, base, batch, accum, card_dev,
                                       accum == 1)
            card_rec["run_s"] = time.perf_counter() - t0
            want = train_launches(cfg, 1, accum)
            rel = {k: abs(card_rec["metrics"][k] - v) / abs(v)
                   for k, v in cpu_rec["metrics"].items()}
            errs = sorted(((rel_err(card[f][n], cpu[f][n]), f, n)
                           for f in ("mu", "nu") for n in cpu["mu"]),
                          reverse=True)
            moments = errs[0][0]
            # a gradient lost at a kernel zeroes a whole parameter; single
            # elements can round to 0 on one device and not the other
            lost = [n for n in cpu["mu"]
                    if cpu["mu"][n].any() and not card["mu"][n].any()]
            only_cpu = torch.cat([cpu["mu"][n][(cpu["mu"][n] != 0)
                                               & (card["mu"][n] == 0)]
                                  for n in cpu["mu"]])
            masters = max(rel_err(card["master"][n], cpu["master"][n])
                          for n in cpu["master"])
            rec = {"card": card_rec, "metrics_rel_err": rel,
                   "moments_rel_err": moments,
                   "moments_worst": [
                       {"tensor": f"{f}:{n}", "rel_err": e,
                        "cpu_largest": float(cpu[f][n].abs().max())}
                       for e, f, n in errs[:4]],
                   "params_with_grad_on_cpu_none_on_card": lost,
                   "elements_nonzero_on_cpu_zero_on_card": only_cpu.numel(),
                   "their_largest_cpu_moment": float(only_cpu.abs().max())
                   if only_cpu.numel() else 0.0,
                   "masters_rel_err": masters,
                   "params_bf16": all(p.dtype == torch.bfloat16
                                      for p in card["params"].values()),
                   "expected_launches": want}
            r[f"grad_accum_{accum}"] = rec
            tag = f"phase 13 {name} grad_accum {accum}"
            defer(all(e <= TRAIN_TOL for e in rel.values()),
                  f"{tag}: loss, grad norm and lr within 1e-4 of the CPU's")
            defer(moments <= TRAIN_TOL,
                  f"{tag}: every gradient (the moments) within 1e-4 of the "
                  "CPU's, relative to its largest")
            defer(not lost,
                  f"{tag}: every parameter the CPU gives a gradient has one "
                  "on the card")
            defer(rec["params_bf16"], f"{tag}: parameters bf16 after a step")
            defer(accum > 1 or np.isfinite(card_rec["loss2"]),
                  f"{tag}: a second step on the card (bf16 A_log and D) "
                  "runs to a finite loss")
            launched_now = card_rec["launches"]
            defer(all(launched_now[k] == n for k, n in want.items())
                  and sum(launched_now.values()) == sum(want.values()),
                  f"{tag}: (1 + remat) x micro-batches x layers launches of "
                  "each forward kernel, micro-batches x layers of each "
                  "backward, nothing else")
            defer(card_rec["flash_variants"]["simt"]
                  == want["flash_attention"]
                  and card_rec["flash_bwd_variants"]["simt"]
                  == want["flash_attention_bwd"],
                  f"{tag}: fp32 flash, forward and backward, on the "
                  "CUDA-core kernels")
            if name == "hymba-1.5b" and accum == 1:
                t0 = time.perf_counter()
                r["adamw_identity"] = adamw_identity(
                    base, {n: t / (1 - b1) for n, t in cpu["mu"].items()},
                    card_dev)
                r["adamw_identity"]["seconds"] = time.perf_counter() - t0
            del card
            torch.cuda.empty_cache()
        defer(not any(cpu_rec["launches"].values()),
              f"phase 13 {name}: the CPU run launched no kernel")
        del cpu
        out[name] = r
        emit(phase13={name: r})             # before its checks
        for cond, what in pending:
            check(cond, what)
        pending.clear()
    ident = out["hymba-1.5b"]["adamw_identity"]
    check(ident["max_rel_err"] <= TRAIN_TOL and ident["param_bf16_steps"] <= 1
          and ident["grad_norm_rel_err"] <= TRAIN_TOL and ident["lr_equal"],
          "phase 13: AdamW on the card equals the CPU's on the same state "
          "and gradients")
    cfg = get_config("hymba-1.5b").smoke()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        t0 = time.perf_counter()
        resumed = train_loop(cfg, steps=8, batch=2, seq=32, ckpt_dir=d,
                             save_every=4, fail_at=5, log=lambda *a: None,
                             device=card_dev)
        seconds = time.perf_counter() - t0
    out["kill_and_resume"] = {
        "model": cfg.name, "final_step": resumed["final_step"],
        "restarts": resumed["restarts"], "events": resumed["events"],
        "seconds": seconds}
    check(resumed["restarts"] == 1 and resumed["final_step"] == 8
          and any("restored at 4" in e for e in resumed["events"]),
          "phase 13: train_loop killed at step 5 resumed from step 4 and "
          "ended at step 8")
    out["checkpoint"] = rt = ckpt_round_trip(cfg, resumed["state"], card_dev)
    check(rt["dtypes_fresh"] and rt["on_card"] and rt["equal"]
          and rt["a_log_dtype"] == "torch.float32",
          "phase 13: the trained state's checkpoint restores on the card "
          "byte-equal, in a fresh state's dtypes")
    return out


def is_gemm(name: str) -> bool:
    return any(g in name.lower() for g in GEMM_KERNELS)


class Spans:
    """Wraps functions, each an attribute of a module or a class (a
    static method there): CUDA events recorded on the stream just before
    and just after each call, so the device time each call spans (every
    operation it launches, any idle gap inside it included) sums per
    name."""

    def __init__(self, targets: dict):
        self.targets = targets
        self.events = {name: [] for name in targets}
        self._orig = {name: getattr(owner, attr)
                      for name, (owner, attr) in targets.items()}

    def _wrap(self, name: str):
        orig = self._orig[name]

        def call(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(*args)
            end.record()
            self.events[name].append((start, end))
            return out
        return call

    def _set(self, owner, attr: str, fn) -> None:
        setattr(owner, attr, staticmethod(fn) if isinstance(owner, type)
                else fn)

    def __enter__(self):
        for name, (owner, attr) in self.targets.items():
            self._set(owner, attr, self._wrap(name))
        return self

    def __exit__(self, *exc):
        for name, (owner, attr) in self.targets.items():
            self._set(owner, attr, self._orig[name])

    def summary(self) -> dict:
        torch.cuda.synchronize()
        return {name: {"device_ms": sum(s.elapsed_time(e) for s, e in ev),
                       "calls": len(ev)}
                for name, ev in self.events.items()}


BACKWARDS = {"flash_attention_backward": (flash_ops.FlashAttention,
                                          "backward"),
             "selective_scan_backward": (scan_ops.SelectiveScanFused,
                                         "backward")}
# the backward kernels' symbols, by the span that launches them
BACKWARD_KERNELS = {
    "flash_attention_backward": ("flash_bwd_dq", "flash_bwd_dkdv"),
    "selective_scan_backward": ("selective_scan_fused_bwd_orders_kernel",
                                "selective_scan_fused_bwd_kernel",
                                "selective_scan_fused_bwd_reduce_kernel")}


def profiled_split(fn) -> dict:
    """``fn`` (one train step) under the profiler's CUDA activity and
    ``Spans`` of the two Functions' backwards: device time by operation,
    and split into the two kernels' forward launches, the spans of the
    Functions' backwards (each span's backward kernels by symbol beside
    it), all GEMMs and the rest outside the spans."""
    with Spans(BACKWARDS) as spans:
        ops = device_ops(fn)
    back = spans.summary()
    total = sum(ms for _, ms, _ in ops)

    def part(hits):
        ms = sum(ms for _, ms, _ in hits)
        return {"device_ms": ms, "launches": sum(n for _, _, n in hits),
                "share": ms / total if total else None}
    fwd = {"flash_fwd": part([o for o in ops if "flash_fwd" in o[0]]),
           "selective_scan_fused": part(
               [o for o in ops if "selective_scan_fused_kernel" in o[0]])}
    for name, b in back.items():
        b["share"] = b["device_ms"] / total if total else None
        b["kernels"] = {sym: part([o for o in ops if sym in o[0]])
                        for sym in BACKWARD_KERNELS[name]}
    outside = total - sum(b["device_ms"] for b in back.values())
    return {"device_ms": total, "forward_kernels": fwd,
            "backward_spans": back,
            "gemms_all": part([o for o in ops if is_gemm(o[0])]),
            "outside_backward_spans_ms": outside,
            "top_ops": [{"op": key[:120], "device_ms": ms, "count": n,
                         "share": ms / total} for key, ms, n in ops[:TOP_OPS]]}


class FirstCalls:
    """Wraps functions, each an attribute of a module: keeps a copy of
    the arguments of the first call of each window (keyword ``window``,
    None where absent), and passes every call through."""

    def __init__(self, targets: dict):
        self.targets = targets
        self.calls = {name: {} for name in targets}
        self._orig = {name: getattr(owner, attr)
                      for name, (owner, attr) in targets.items()}

    def _wrap(self, name: str):
        orig, kept = self._orig[name], self.calls[name]

        def call(*args, **kw):
            key = kw.get("window")
            if key not in kept:
                kept[key] = (tuple(t.detach().clone() for t in args),
                             dict(kw))
            return orig(*args, **kw)
        return call

    def __enter__(self):
        for name, (owner, attr) in self.targets.items():
            setattr(owner, attr, self._wrap(name))
        return self

    def __exit__(self, *exc):
        for name, (owner, attr) in self.targets.items():
            setattr(owner, attr, self._orig[name])


BWD_WRAPPERS = {"selective_scan_fused_bwd": (fused_kernel,
                                             "selective_scan_fused_bwd"),
                "flash_attention_bwd": (flash_kernel, "flash_attention_bwd")}
BWD_REPLACES = {
    "selective_scan_fused_bwd": "src/repro/models/layers.py:353",
    "flash_attention_bwd": "src/repro/kernels/flash_attention/ops.py:42"}
# per (t, d, n): g 2, dB 2, dC 2, dx 2, ddt 4 (x B + A decay h), dA 2
SCAN_BWD_FLOPS = 14
# the backward kernel's exponentials a (t, d, n): its pass 1 and its
# recompute (the walk back reuses the recompute's decays)
SCAN_BWD_EXPONENTIALS = 2
FLASH_BWD_FLOPS = 10          # QK^T, dO V^T, P^T dO, dS^T Q, dS K


def scan_bwd_bound(args) -> tuple:
    """(bytes / HBM rate, flops / CUDA-core rate) in seconds of one
    backward call (dt, x, B, C, A, dy): dt, x, dy, B, C, A read once,
    their gradients written once; SCAN_BWD_FLOPS per (t, d, n)."""
    dt, a = args[0], args[4]
    b, t, di = dt.shape
    n = a.shape[1]
    nbytes = 4 * (5 * b * t * di + 4 * b * t * n + 2 * di * n)
    return nbytes / HBM_BYTES_PER_S, \
        SCAN_BWD_FLOPS * b * t * di * n / CUDA_CORE_OPS_PER_S


def flash_bwd_bound(args, causal, window) -> tuple:
    """(bytes / HBM rate, ops / peak rate of the inputs' type) in seconds
    of one backward call (q, k, v, out, lse, dout): q, out, dout, k, v and
    lse read once, dq, dk, dv written once; FLASH_BWD_FLOPS per (query
    head, visible key, head dim), visible as in ``flash_bound``."""
    q, k, _, _, lse, _ = args
    b, h, sq, d = q.shape
    skv = k.shape[2]
    seen = float(np.minimum(np.minimum(np.arange(1, sq + 1), skv),
                            window or skv).sum()) if causal else sq * skv
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
        + 4 * lse.numel()
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 \
        else CUDA_CORE_OPS_PER_S
    return nbytes / HBM_BYTES_PER_S, \
        FLASH_BWD_FLOPS * b * h * d * seen / rate


class DispatchLog(TorchDispatchMode):
    """Every aten operation dispatched in this thread while active, by
    name: every PyTorch kernel launch passes through the dispatcher, so a
    plain recompute shows here whatever the profiler records."""

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.add(str(func))
        return func(*args, **(kwargs or {}))


def backward_ops(forward, inputs: tuple, grad: torch.Tensor) -> dict:
    """One backward through ``forward`` (a differentiable entry point) on
    copies of ``inputs``, the forward run first and outside: the aten
    operations its ``Function``'s backward dispatches (run in this thread
    through the node's ``apply``) and the device operations the profiler
    records for it (in whole-script runs it has come back with none)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in inputs]
        out = forward(*ins)
    log = DispatchLog()

    def run():
        with log:
            out.grad_fn.apply(grad)
    device = device_ops(run)
    return {"aten_ops": sorted(log.ops),
            "device_ops": sorted({name for name, _, _ in device})}


# aten ops that launch no kernel: allocations, and the detach that
# unpacking a saved output (flash's out) dispatches
NO_KERNEL_OPS = ("aten.empty", "aten.detach.")


def only_kernels(seen: dict, symbol: str) -> bool:
    """Whether a backward dispatched no aten op that launches a kernel and
    launched no device operation but its own kernels (``symbol`` in their
    names)."""
    return (all(op.startswith(NO_KERNEL_OPS) for op in seen["aten_ops"])
            and all(symbol in op for op in seen["device_ops"]))


def sdpa_backward(call, causal, window):
    """(fn, args): the backward of one ``scaled_dot_product_attention``
    call on the same q, k, v (K/V repeated to the query heads outside the
    timed call) at ``dout``, its graph kept between calls."""
    q, k, v, _, _, dout = call
    fn, (q_, k_, v_, mask) = flash_library((q, k, v, causal, window), False)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q_, k_, v_)]
        out = fn(*leaves, mask)
    return (lambda: torch.autograd.grad(out, leaves, dout,
                                        retain_graph=True)), ()


def phase_train_backward(calls: dict, launched: dict) -> list:
    """The first backward call of phase 14's loop (the scan's, and
    flash's of each window) again: checked against the plain backward,
    timed with CUDA events beside its bound, the plain version and, for
    flash, ``scaled_dot_product_attention``'s backward; and one backward
    through each ``Function`` under the profiler: its device operations
    are the backward kernels and nothing else.  The kernels line's rows
    for the two backward kernels."""
    rows = []
    (scan_args, _), = calls["selective_scan_fused_bwd"].values()
    got = fused_kernel.selective_scan_fused_bwd(*scan_args)
    want = selective_scan_fused_bwd_ref(*scan_args)
    rel = max(card_rel_err(x, y) for x, y in zip(got, want))
    err = max(float((x - y).abs().max()) for x, y in zip(got, want))
    del got, want
    check(rel <= SCAN_TOL, f"phase 14 scan backward within {SCAN_TOL} of "
          "the plain backward on the loop's first call")
    scan_ops_seen = backward_ops(scan_ops.selective_scan_fused,
                                 scan_args[:5], scan_args[5])
    check(only_kernels(scan_ops_seen, "selective_scan_fused_bwd"),
          "phase 14: the scan Function's backward launches its backward "
          "kernels and nothing else")
    t_bytes, t_ops = scan_bwd_bound(scan_args)
    sfu_per_s = (fused_kernel.sm_count(scan_args[0].device) * SFU_PER_CLOCK
                 * max_sm_hz())
    wrapper = fused_kernel.selective_scan_fused_bwd
    sms = fused_kernel.sm_count(scan_args[0].device)
    plan = fused_kernel.bwd_plan(scan_args[0].shape[0],
                                 scan_args[0].shape[2], sms)
    occ = fused_kernel.bwd_occupancy(plan.channels, scan_args[0].device)
    device_ms = bracketed_ms(wrapper, [scan_args], 3)
    rows.append({
        "name": "selective_scan_fused_bwd", "route": "cuda",
        "source": str(SCAN_SOURCE.relative_to(ROOT)),
        "replaces": BWD_REPLACES["selective_scan_fused_bwd"],
        "launches": launched["selective_scan_fused_bwd"],
        "max_abs_err": err, "max_rel_err": rel, "dtype": "float32",
        "shape": list(scan_args[0].shape) + [scan_args[4].shape[1]],
        "plan": {"channels": plan.channels, "grid": list(plan.grid),
                 **occ._asdict(), "waves": plan.grid[0] * plan.grid[1]
                 / (sms * occ.blocks_per_sm)},
        "ms": cuda_ms(wrapper, [scan_args], 5),
        "device_ms": device_ms,
        "plain_ms": cuda_ms(selective_scan_fused_bwd_ref, [scan_args], 1),
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_share": 1e3 * max(t_bytes, t_ops) / device_ms,
        "bound_sfu_ms": 1e3 * SCAN_BWD_EXPONENTIALS * scan_sfu_bound(
            scan_args, sfu_per_s),
        "library_ms": None, "backward_ops": scan_ops_seen})
    del scan_args
    torch.cuda.empty_cache()
    by_window, worst = {}, (0.0, 0.0)
    wrapper = flash_kernel.flash_attention_bwd
    for window, (args, kw) in calls["flash_attention_bwd"].items():
        causal = kw["causal"]
        got = wrapper(*args, **kw)
        want = per_kv_head(attention_bwd_ref, *args[:4], args[5], **kw)
        rel = max(card_rel_err(x, y) for x, y in zip(got, want))
        err = max(float((x.float() - y.float()).abs().max())
                  for x, y in zip(got, want))
        del got, want
        check(rel <= FLASH_BWD_TOL[args[0].dtype],
              f"phase 14 flash backward (window {window}) within "
              f"{FLASH_BWD_TOL[args[0].dtype]} of the plain backward on "
              "the loop's first call")
        ops_seen = backward_ops(
            lambda q, k, v: flash_ops.flash_attention(q, k, v, causal,
                                                      window),
            args[:3], args[5])
        check(only_kernels(ops_seen, "flash_bwd_"),
              "phase 14: flash's Function backward launches its backward "
              "kernels and nothing else")
        t_bytes, t_ops = flash_bwd_bound(args, causal, window)
        lib_fn, lib_args = sdpa_backward(args, causal, window)
        by_window[str(window)] = {
            "shape": list(args[0].shape) + [args[1].shape[1]],
            "dtype": str(args[0].dtype).split(".")[1],
            "causal": causal, "window": window,
            "variant": flash_kernel.bwd_variant(args[0].dtype,
                                                args[0].shape[3]),
            "max_abs_err": err, "max_rel_err": rel,
            "ms": cuda_ms(lambda: wrapper(*args, **kw), [()], 5),
            "device_ms": bracketed_ms(lambda: wrapper(*args, **kw), [()],
                                      3),
            "plain_ms": cuda_ms(lambda: per_kv_head(
                attention_bwd_ref, *args[:4], args[5], **kw), [()], 1),
            "library_ms": cuda_ms(lib_fn, [lib_args], 5),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "backward_ops": ops_seen}
        worst = (max(worst[0], err), max(worst[1], rel))
        del lib_fn, lib_args
        torch.cuda.empty_cache()
    first = next(iter(by_window.values()))
    rows.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": str(flash_kernel.SOURCE.relative_to(ROOT)),
        "replaces": BWD_REPLACES["flash_attention_bwd"],
        "launches": launched["flash_attention_bwd"],
        "max_abs_err": worst[0], "max_rel_err": worst[1],
        "dtype": first["dtype"],
        **{k: first[k] for k in ("ms", "device_ms", "plain_ms",
                                 "library_ms", "bound_ms", "bound_by")},
        "first_call_window": first["window"], "by_window": by_window})
    return rows


def phase_train_main(dev: str = "cuda") -> dict:
    """Phase 14: Hymba-1.5B at full width and depth trains through
    ``train_loop`` (bf16 parameters, fp32 masters and moments, remat on,
    random weights from seed 0, SyntheticLM data), the launch counts
    zeroed just before and read just after; then one more step of the
    same state under the profiler; then the loop's first call of each
    backward kernel again (``phase_train_backward``)."""
    cfg = get_config(TRAIN_MAIN)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stamps = []

    def log(msg):
        stamps.append((time.perf_counter(), msg))
    reset_model_launches()
    t0 = time.perf_counter()
    with FirstCalls(BWD_WRAPPERS) as first:
        out = train_loop(cfg, steps=TRAIN_MAIN_STEPS,
                         batch=TRAIN_MAIN_BATCH, seq=TRAIN_MAIN_SEQ,
                         log_every=1, log=log, device=dev)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = model_launches()
    variants = dict(flash_kernel.variant_launches)
    bwd_variants = dict(flash_kernel.bwd_variant_launches)
    peak = torch.cuda.max_memory_allocated()
    gnorms = [float(msg.split("gnorm ")[1]) for _, msg in stamps]
    times = [t for t, _ in stamps]
    tokens = TRAIN_MAIN_BATCH * TRAIN_MAIN_SEQ
    later = times[-1] - times[0]
    want = train_launches(cfg, TRAIN_MAIN_STEPS, 1)
    state = out["state"]
    rec = {"model": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model,
           "params": sum(p.numel() for p in state["model"].parameters()),
           "batch": [TRAIN_MAIN_BATCH, TRAIN_MAIN_SEQ],
           "steps": out["final_step"], "wall_s": wall,
           "first_step_and_init_s": times[0] - t0,
           "step_s": [b - a for a, b in zip(times, times[1:])],
           "mean_step_s_2_on": later / (len(times) - 1),
           "tokens_per_s_2_on": tokens * (len(times) - 1) / later,
           "losses": [loss for _, loss in out["losses"]],
           "grad_norms": gnorms, "launches": launched,
           "flash_variants": variants, "flash_bwd_variants": bwd_variants,
           "expected_launches": want,
           "peak_device_gib": peak / 2**30,
           "param_dtypes": sorted({str(p.dtype) for p in
                                   state["model"].parameters()})}
    check(out["final_step"] == TRAIN_MAIN_STEPS
          and len(rec["losses"]) == TRAIN_MAIN_STEPS,
          "phase 14: every step ran and logged")
    check(all(np.isfinite(rec["losses"])) and all(np.isfinite(gnorms)),
          "phase 14: finite losses and grad norms")
    check(all(launched[k] == n for k, n in want.items())
          and sum(launched.values()) == sum(want.values()),
          "phase 14: 2 x 32 flash and 2 x 32 fused-scan forward launches "
          "and 32 of each backward a step, nothing else")
    check(variants == {"mma": want["flash_attention"], "simt": 0}
          and bwd_variants == {"mma": want["flash_attention_bwd"],
                               "simt": 0},
          "phase 14: every flash launch, forward and backward, on the "
          "tensor-core kernels")
    step = make_train_step(cfg, TrainConfig(total_steps=TRAIN_MAIN_STEPS),
                           ParallelConfig(seq_shard_activations=False))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        cfg.vocab_size, TRAIN_MAIN_BATCH, TRAIN_MAIN_SEQ).batch_at(
            TRAIN_MAIN_STEPS).items()}
    holder = {"state": state}

    def one():
        holder["state"], m = step(holder["state"], batch)
        holder["loss"] = m["loss"]
    split = profiled_split(one)
    check(np.isfinite(float(holder["loss"])),
          "phase 14: the profiled step's loss is finite")
    split["busy_share"] = split["device_ms"] / (1e3 * rec["mean_step_s_2_on"])
    rec["profiled_step"] = split
    del out, state, holder, batch
    torch.cuda.empty_cache()
    rec["backward_kernels"] = phase_train_backward(first.calls, launched)
    del first
    torch.cuda.empty_cache()
    return rec


# ----------------------------------------------------------------------
# phases 15 and 16: the moe, encdec and vlm families
# ----------------------------------------------------------------------
# phase 15: (model, layers or None for all, prompts x tokens of its forward
# and prefill); its decode teacher-forces FAMILY_IDENT_PROMPT tokens and
# generates FAMILY_IDENT_NEW; then one train step of each smoke config
FAMILY_IDENTITY = [("olmoe-1b-7b", 2, 2, 64), ("whisper-base", None, 2, 64),
                   ("internvl2-26b", 2, 2, 272)]   # past the 256 prefix
FAMILY_IDENT_PROMPT, FAMILY_IDENT_NEW = 8, 8
NO_DROP_TOKENS = 64           # the MoE's decode vs forward, no pair dropped
FAMILY_TRAIN = ["olmoe-1b-7b", "whisper-base", "internvl2-26b"]
FAMILY_TOL = 1e-4
# phase 16: (model, layers or None for all, prompts, tokens); the decode
# starts from the prefill's context: its caches hold the prefill's k and
# v of all but the last FAMILY_PROMPT prompt tokens, which it
# teacher-forces before it generates FAMILY_NEW (Mixtral's 4,096-slot
# ring past its wrap, from position 8,160)
FAMILY_MAIN = [("olmoe-1b-7b", None, 4, 2048),
               ("internvl2-26b", None, 4, 2048),
               ("mixtral-8x22b", 12, 1, 8192),   # 12 of 56 layers
               ("whisper-base", None, 4, 448)]
FAMILY_PROMPT, FAMILY_NEW = 32, 32
# the decode's logits at the last prompt position against the prefill's,
# relative to the largest, bf16 (tests/test_torch_models.py's bound for
# the same comparison), on the families checked: a MoE's expert choice
# can flip on a near-tie between the two paths' bf16 activations, so
# the moe family's error is reported, not checked
PREFILL_DECODE_TOL = 3e-2
MIN_FREE_GIB = 8              # device memory a cut model must leave free


def family_cfg(name: str, layers):
    cfg = get_config(name)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def family_batch(cfg, b: int, t: int, seed: int) -> dict:
    """Seeded numpy inputs of one prefill: tokens [b, t] and, for encdec,
    ``frames`` [b, encoder_seq, d] (the stubbed audio frontend's output),
    for vlm ``vision_embeds`` [b, vision_prefix, d] (the stubbed vision
    frontend's), both normal at the embedding's scale, fp32."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(
        np.int32)}
    scale = cfg.d_model ** -0.5
    for key, n in (("frames", cfg.encoder_layers and cfg.encoder_seq),
                   ("vision_embeds", cfg.vision_prefix)):
        if n:
            out[key] = (rng.standard_normal((b, n, cfg.d_model))
                        * scale).astype(np.float32)
    return out


def to_dev(batch: dict, dev, dtype=None) -> dict:
    """A numpy batch as tensors on ``dev``, the float ones cast to
    ``dtype`` if given."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v).to(dev)
        out[k] = t.to(dtype) if dtype is not None and t.is_floating_point() \
            else t
    return out


def flash_per_forward(cfg) -> dict:
    """Flash launches of one forward by kind: causal self-attention a
    decoder layer, non-causal self-attention an encoder layer, and
    cross-attention a decoder layer of an encdec model."""
    return {"self": cfg.num_layers, "encoder": cfg.encoder_layers,
            "cross": cfg.num_layers if cfg.encoder_layers else 0}


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def cross_kv(cfg, model, batch: dict):
    """An encdec model's cross K/V of ``batch["frames"]`` (``_encode``,
    then ``encoder_kv``), None for the other families."""
    if not cfg.encoder_layers:
        return None
    with torch.no_grad():
        return encoder_kv(cfg, model, M._encode(cfg, model,
                                                batch["frames"]))


def family_identity_run(cfg, model, batch: dict, short: np.ndarray,
                        dev) -> dict:
    """``forward``, ``make_prefill_step`` and a teacher-forced
    ``make_serve_step`` (fp32 caches; an encdec model's cross caches from
    its encoder) of one model on ``dev``, the counts zeroed just before
    and read just after; the MoE's experts and kept slots of every call.
    Off the CPU it runs a copy of ``model`` moved to ``dev``."""
    if torch.device(dev).type != "cpu":
        model = copy.deepcopy(model).to(dev)
    tb = to_dev(batch, dev)
    reset_model_launches()
    with ModelRecorder(routes=True) as rec:
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = forward(cfg, model, tb)
        nxt = make_prefill_step(cfg)(model, tb)
        _, gen, logs, nonfinite, steps = serve(
            cfg, model, short, FAMILY_IDENT_NEW, dev, keep_logits=True,
            cache_dtype=torch.float32, cross=cross_kv(cfg, model, tb))
        sync(dev)
        wall = time.perf_counter() - t0
    return {"forward": logits.float().cpu(), "prefill": nxt.float().cpu(),
            "decode": torch.stack(logs, 1), "gen": gen.cpu(), "steps": steps,
            "nonfinite": int(nonfinite) + int((~torch.isfinite(logits)).sum()),
            "experts": rec.experts, "kept": rec.kept, "kinds": rec.kinds,
            "launches": model_launches(),
            "variants": dict(flash_kernel.variant_launches), "wall_s": wall}


def family_train_identity(card_dev, defer) -> dict:
    """One ``make_train_step`` step (remat on) of each FAMILY_TRAIN smoke
    config on the card and on the CPU from one fp32 ``init_state``: loss
    and grad norm within FAMILY_TOL, every parameter with a gradient on
    the CPU with one on the card (the fp32 router included), (1 + remat)
    flash forward launches per attention call of the forward and one
    backward launch per call."""
    out = {}
    for name in FAMILY_TRAIN:
        cfg = get_config(name).smoke()
        base = init_state(cfg, seed=0, device="cpu", dtype=torch.float32)
        batch = {**family_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, 15),
                 **SyntheticLM(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                               seed=13).batch_at(0)}
        cpu, cpu_rec = train_run(cfg, base, batch, 1, "cpu", False)
        card, card_rec = train_run(cfg, base, batch, 1, card_dev, False)
        rel = {k: abs(card_rec["metrics"][k] - cpu_rec["metrics"][k])
               / abs(cpu_rec["metrics"][k]) for k in ("loss", "grad_norm")}
        lost = [n for n in cpu["mu"]
                if cpu["mu"][n].any() and not card["mu"][n].any()]
        zero_card = [n for n in card["mu"] if not card["mu"][n].any()]
        routers = [n for n in card["mu"] if n.endswith("moe.router")]
        calls = sum(flash_per_forward(cfg).values())
        want = 2 * calls
        launched = card_rec["launches"]
        out[name] = r = {
            "layers": cfg.num_layers, "encoder_layers": cfg.encoder_layers,
            "batch": [TRAIN_BATCH, TRAIN_SEQ], "metrics_rel_err": rel,
            "cpu": cpu_rec, "card": card_rec,
            "params_with_grad_on_cpu_none_on_card": lost,
            "params_without_grad_on_card": zero_card,
            "routers_with_grad_on_card": sum(bool(card["mu"][n].any())
                                             for n in routers),
            "expected_flash": want, "expected_flash_bwd": calls}
        tag = f"phase 15 {name} smoke train step"
        defer(all(e <= FAMILY_TOL for e in rel.values()),
              f"{tag}: loss and grad norm within 1e-4 of the CPU's")
        defer(not lost and not zero_card,
              f"{tag}: every parameter has a gradient on the card")
        defer(r["routers_with_grad_on_card"] == len(routers)
              and len(routers) == (cfg.num_layers if cfg.is_moe else 0),
              f"{tag}: the fp32 router of every MoE layer has a gradient")
        defer(launched["flash_attention"] == want
              and launched["flash_attention_bwd"] == calls
              and sum(launched.values()) == want + calls,
              f"{tag}: (1 + remat) flash forward launches and one backward "
              "launch per attention call, nothing else")
        defer(not any(cpu_rec["launches"].values()),
              f"{tag}: the CPU run launched no kernel")
    return out


def tied_routes(cfg, model, card_dev) -> dict:
    """The MoE's routing on tied gates, layer 0's router of ``model`` on the
    card and on the CPU: a zero router input (all E gates equal) and an
    input near 1 against a router whose columns 3 and 5 are equal and
    lead every token's gates.  The experts and kept slots of each case
    on both devices, and whether the ties went to the lower expert first,
    as the reference's ``jax.lax.top_k`` takes them."""
    e, k = cfg.num_experts, cfg.top_k
    cap = L.moe_capacity(cfg, 64)
    rng = np.random.default_rng(17)
    tied = model.layers[0].moe.router.detach().clone()
    tied[:, 3] = tied[:, 5] = 1.0
    near_one = 1.0 + 0.1 * rng.standard_normal((2, 64, cfg.d_model))
    cases = {"zero_input": (torch.zeros(2, 64, cfg.d_model),
                            model.layers[0].moe.router.detach()),
             "equal_columns": (torch.from_numpy(near_one.astype(np.float32)),
                               tied)}
    want_head = {"zero_input": torch.arange(k), "equal_columns":
                 torch.tensor([3, 5])}
    out = {}
    for case, (x, router) in cases.items():
        got = {}
        for dev in (card_dev, "cpu"):
            p = SimpleNamespace(router=router.to(dev))
            with torch.no_grad():
                _, top_e = L.moe_route(p, cfg, x.to(dev))
                pos, keep = L.moe_slots(top_e, e, cap)
            got[dev] = (top_e.cpu(), pos.cpu(), keep.cpu())
        (ce, cp, ck), (he, hp, hk) = got[card_dev], got["cpu"]
        head = want_head[case]
        out[case] = {
            "experts_identical": bool(torch.equal(ce, he)),
            "kept_identical": bool(torch.equal(cp, hp)
                                   and torch.equal(ck, hk)),
            "lower_expert_first": bool(
                (ce[..., :len(head)] == head).all()),
            "first_token_experts": ce[0, 0].tolist(),
            "dropped_pairs": int((~ck).sum())}
    return out


def no_drop_decode(cfg, model, card_dev) -> dict:
    """The MoE at a capacity factor of E / k, where an expert has a slot
    for every token of a row and no pair drops, on the card: ``forward``
    over NO_DROP_TOKENS seeded tokens a row, then ``make_serve_step``
    teacher-forcing the same tokens into fp32 caches; each position's
    decode logits against the forward's, relative to the row's largest
    (held at PREFILL_DECODE_TOL), and the pairs the forward dropped."""
    cfg = dataclasses.replace(cfg,
                              capacity_factor=cfg.num_experts / cfg.top_k)
    model = copy.deepcopy(model).to(card_dev)
    toks = np.random.default_rng(18).integers(
        0, cfg.vocab_size, (2, NO_DROP_TOKENS)).astype(np.int32)
    with ModelRecorder(routes=True) as rec:
        with torch.no_grad():
            full = forward(cfg, model, {"tokens": torch.from_numpy(
                toks).to(card_dev)}).float().cpu()
        dropped = sum(int((~k).sum()) for k in rec.kept)
    _, _, logs, nonfinite, _ = serve(cfg, model, toks, 1, card_dev,
                                     keep_logits=True,
                                     cache_dtype=torch.float32)
    dec = torch.stack(logs, 1)
    err = ((dec - full).abs().amax(-1) / full.abs().amax(-1)).amax()
    return {"capacity_factor": cfg.capacity_factor,
            "tokens": list(toks.shape), "dropped_pairs": dropped,
            "max_rel_err": float(err), "nonfinite": int(nonfinite)}


def phase_family_identity(card_dev: str = "cuda") -> dict:
    """Phase 15: each FAMILY_IDENTITY model at full width (cut in depth
    where given), fp32 from one seeded init_model, TF32 off, on the card
    and on the CPU: forward and prefill logits within FAMILY_TOL of the
    largest, the teacher-forced decode's too (fp32 caches: bf16 ones
    round values a few ulps apart to neighbouring bf16 values), greedy
    tokens and MoE routing identical, one flash launch per attention call
    on the card and none on the CPU; then the smoke train steps.  Each
    model's record prints before its checks."""
    out, pending = {}, []

    def defer(cond: bool, what: str) -> None:
        pending.append((cond, what))

    def settle() -> None:
        for cond, what in pending:
            check(cond, what)
        pending.clear()
    for name, layers, b, t in FAMILY_IDENTITY:
        cfg = family_cfg(name, layers)
        t0 = time.perf_counter()
        model = init_model(cfg, seed=0, device="cpu", dtype=torch.float32)
        init_s = time.perf_counter() - t0
        batch = family_batch(cfg, b, t, 15)
        short = np.random.default_rng(16).integers(
            0, cfg.vocab_size, (b, FAMILY_IDENT_PROMPT)).astype(np.int32)
        runs = {dev: family_identity_run(cfg, model, batch, short, dev)
                for dev in (card_dev, "cpu")}
        torch.cuda.empty_cache()
        card, cpu = runs[card_dev], runs["cpu"]
        per = flash_per_forward(cfg)
        want = {k: 2 * n for k, n in per.items()}   # forward and prefill
        want["encoder"] += cfg.encoder_layers       # the cross caches
        want["cross"] += card["steps"] * per["cross"]
        r = {"layers": cfg.num_layers, "encoder_layers": cfg.encoder_layers,
             "params": sum(p.numel() for p in model.parameters()),
             "prefill_tokens": [b, t],
             "serve": [b, FAMILY_IDENT_PROMPT, FAMILY_IDENT_NEW],
             "forward_rel_err": rel_err(card["forward"], cpu["forward"]),
             "prefill_rel_err": rel_err(card["prefill"], cpu["prefill"]),
             "decode_rel_err": rel_err(card["decode"], cpu["decode"]),
             "tokens_identical": bool(torch.equal(card["gen"], cpu["gen"])),
             "moe_calls": len(card["experts"]),
             "experts_identical": len(card["experts"]) == len(cpu["experts"])
             and all(torch.equal(a, c) for a, c in zip(card["experts"],
                                                       cpu["experts"])),
             "kept_identical": len(card["kept"]) == len(cpu["kept"])
             and all(torch.equal(a, c) for a, c in zip(card["kept"],
                                                       cpu["kept"])),
             "dropped_pairs": int(sum(int((~k).sum()) for k in cpu["kept"])),
             "flash_kinds": card["kinds"], "expected_flash_kinds": want,
             "launches": {d: r_["launches"] for d, r_ in runs.items()},
             "flash_variants": card["variants"],
             "init_s": init_s, "wall_s": {d: r_["wall_s"]
                                          for d, r_ in runs.items()}}
        if cfg.is_moe:
            r["tied_gates"] = tied_routes(cfg, model, card_dev)
            r["no_drop_decode"] = no_drop_decode(cfg, model, card_dev)
        out[name] = r
        emit(phase15={name: r})
        tag = f"phase 15 {name}"
        for key in ("forward", "prefill", "decode"):
            defer(r[f"{key}_rel_err"] <= FAMILY_TOL,
                  f"{tag}: card {key} logits within 1e-4 of the CPU's")
        defer(r["tokens_identical"], f"{tag}: greedy tokens identical")
        defer(r["experts_identical"] and r["kept_identical"]
              and (r["moe_calls"] > 0) == cfg.is_moe,
              f"{tag}: MoE experts and kept slots identical on every call")
        defer(card["nonfinite"] == cpu["nonfinite"] == 0,
              f"{tag}: finite logits")
        nd = r.get("no_drop_decode")
        defer(nd is None or (nd["dropped_pairs"] == 0 and nd["nonfinite"]
                             == 0 and nd["max_rel_err"]
                             <= PREFILL_DECODE_TOL),
              f"{tag} at capacity factor E / k: no pair dropped, decode "
              f"within {PREFILL_DECODE_TOL} of forward at every position")
        for case, t in r.get("tied_gates", {}).items():
            defer(t["experts_identical"] and t["kept_identical"]
                  and t["lower_expert_first"],
                  f"{tag} tied gates ({case}): experts and kept slots "
                  "identical on card and CPU, the lower expert first")
        n = sum(want.values())
        defer(card["kinds"] == want
              and card["launches"]["flash_attention"] == n
              and sum(card["launches"].values()) == n,
              f"{tag}: one flash launch per attention call (decoder, "
              "encoder, cross; cross in every decode step), nothing else")
        defer(card["variants"] == {"mma": 0, "simt": n},
              f"{tag}: fp32 flash on the CUDA-core kernel")
        defer(not any(cpu["launches"].values()),
              f"{tag}: the CPU run launched no kernel")
        settle()
        del model, runs
    out["train"] = family_train_identity(card_dev, defer)
    emit(phase15={"train": out["train"]})
    settle()
    return out


def prefill_caches(cfg, kv: list, b: int, max_len: int, n: int,
                   dev) -> dict:
    """``init_caches`` of ``max_len`` positions holding the prefill's k
    and v (``kv``: one (k, v) [B, KV, T, D] a decoder layer, as flash took
    them) of positions 0 .. n - 1, position p in slot p % S as decode
    writes it: the last S of them in a ring of S slots."""
    caches = init_caches(cfg, b, max_len, device=dev)
    check(len(kv) == cfg.num_layers, "phases 16, 20: one k and v a decoder "
          "layer kept from the prefill")
    s = caches["k"].shape[2]
    pos = torch.arange(max(0, n - s), n, device=dev)
    for li, (k, v) in enumerate(kv):
        for key, t in (("k", k), ("v", v)):
            caches[key][li][:, pos % s] = t[:, :, pos].transpose(1, 2).to(
                caches[key].dtype)
    return caches


def phase_family_main(name: str, layers, b: int, t: int,
                      dev: str = "cuda", phase: str = "16",
                      then=None, prompt: int = FAMILY_PROMPT,
                      new: int = FAMILY_NEW) -> tuple:
    """Phase 16, one model: bf16 random weights (seed 0) made on the card,
    ``make_prefill_step`` on b prompts of t tokens (with frames or vision
    embeddings), then an encdec model's cross K/V (``encoder_kv``), then
    ``make_serve_step`` from the prefill's context: caches holding the
    prefill's k and v of its first t - ``prompt`` positions, the last
    ``prompt`` prompt tokens teacher-forced, ``new`` generated; the
    counts zeroed before and read after each; the first flash call of
    each signature kept.  The decode's logits at the last prompt position
    are held against the prefill's (PREFILL_DECODE_TOL) on the families
    whose caches hold the whole context and that route no token through
    experts; then one prefill and BUSY_STEPS decode steps under the
    profiler.  ``phase`` names the record's line and its checks; ``then``,
    if given, is called with (cfg, model) once the rest is freed and before
    the model is (phase 20b serves Granite with the same weights).
    Returns (record, kept flash calls)."""
    cfg = family_cfg(name, layers)
    torch.cuda.empty_cache()
    t0 = start = time.perf_counter()
    model = init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    host = family_batch(cfg, b, t, 16)
    batch = to_dev(host, dev, L.DTYPE)
    n0 = t - prompt                         # positions decode finds cached
    tail = host["tokens"][:, n0:]
    per = flash_per_forward(cfg)
    torch.cuda.reset_peak_memory_stats()
    with ModelRecorder(per_signature=True, keep_kv=True) as rec:
        reset_model_launches()
        t0 = time.perf_counter()
        logits = make_prefill_step(cfg)(model, batch)
        nonfinite = int((~torch.isfinite(logits)).sum())
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        dropped, tokens_dropped = int(rec.dropped), int(rec.tokens_dropped)
        prefill = {"batch": b, "tokens": t, "seconds": prefill_s,
                   "tokens_per_s": b * t / prefill_s,
                   "launches": model_launches(),
                   "flash_variants": dict(flash_kernel.variant_launches),
                   "flash_kinds": dict(rec.kinds),
                   "flash_signatures": rec.signature_counts(),
                   "moe_pairs": rec.pairs, "dropped_pairs": dropped,
                   "dropped_share": dropped / rec.pairs if rec.pairs
                   else 0.0, "tokens_dropped": tokens_dropped}
        caches = prefill_caches(cfg, rec.kv, b, t + new, n0, dev)
        rec.kv.clear()
        rec.keep_kv = False
        encode = None
        rec.reset()
        reset_model_launches()
        t0 = time.perf_counter()
        cross = cross_kv(cfg, model, batch)
        if cross is not None:
            torch.cuda.synchronize()
            encode = {"seconds": time.perf_counter() - t0,
                      "launches": model_launches(),
                      "flash_variants": dict(flash_kernel.variant_launches),
                      "flash_kinds": dict(rec.kinds),
                      "flash_signatures": rec.signature_counts()}
            caches["cross_k"], caches["cross_v"] = cross
            rec.reset()
            reset_model_launches()
        t0 = time.perf_counter()
        _, gen, last, dec_nonfinite, steps = serve(
            cfg, model, tail, new, dev,
            keep_logits=prompt - 1, caches=caches, start=n0)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        slots = caches["k"].shape[2]
        decode = {"batch": b, "prompt": prompt, "new": new,
                  "steps": steps, "seconds": decode_s,
                  "tokens_per_s": b * steps / decode_s,
                  "new_tokens": int(gen.numel()),
                  "context": [n0, n0 + steps], "cache_positions": slots,
                  "slots_written": [n0 % slots, (n0 + steps - 1) % slots],
                  "launches": model_launches(),
                  "flash_variants": dict(flash_kernel.variant_launches),
                  "flash_kinds": dict(rec.kinds),
                  "flash_signatures": rec.signature_counts()}
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    want, got = logits.float(), last[0].float()
    rows = ((got - want).abs().amax(-1) / want.abs().amax(-1)).tolist()
    checked = not cfg.is_moe and slots >= t
    del logits, last
    ops = device_ops(lambda: make_prefill_step(cfg)(model, batch))
    prefill_dev = sum(ms for _, ms, _ in ops)
    step_dev = device_busy_ms(lambda: serve(
        cfg, model, tail[:, :8], BUSY_STEPS - 7, dev, keep_logits=False,
        caches=caches, start=n0)) / BUSY_STEPS
    flash_ops_ = [(ms, n) for key, ms, n in ops if "flash_fwd" in key]
    sort_ops = [(ms, n) for key, ms, n in ops if "sort" in key.lower()]
    out = {
        "model": cfg.name, "layers": cfg.num_layers,
        "of_layers": get_config(name).num_layers,
        "encoder_layers": cfg.encoder_layers, "d_model": cfg.d_model,
        "params": sum(p.numel() for p in model.parameters()),
        "load_s": load_s, "prefill": prefill, "encode": encode,
        "decode": decode, "peak_device_gib": peak / 2**30,
        "free_device_gib": (total - peak) / 2**30,
        "nonfinite_logits": nonfinite + int(dec_nonfinite),
        "prefill_vs_decode_rel_err": rows,
        "prefill_vs_decode_checked": checked,
        "prefill_device_ms": prefill_dev,
        "prefill_busy_share": prefill_dev / (1e3 * prefill_s),
        "prefill_top_ops": [{"op": key[:120], "device_ms": ms, "count": n,
                             "share": ms / prefill_dev}
                            for key, ms, n in ops[:TOP_OPS]],
        "prefill_flash": {"device_ms": sum(ms for ms, _ in flash_ops_),
                          "launches": sum(n for _, n in flash_ops_),
                          "share": sum(ms for ms, _ in flash_ops_)
                          / prefill_dev},
        "prefill_sort": {"device_ms": sum(ms for ms, _ in sort_ops),
                         "launches": sum(n for _, n in sort_ops)},
        "decode_device_ms_per_step": step_dev,
        "decode_wall_ms_per_step": 1e3 * decode_s / steps,
        "decode_busy_share": step_dev * steps / (1e3 * decode_s)}
    out["wall_s"] = time.perf_counter() - start
    out["flash_launches"] = (prefill["launches"]["flash_attention"]
                             + decode["launches"]["flash_attention"]
                             + (encode["launches"]["flash_attention"]
                                if encode else 0))
    emit(**{f"phase{phase}": {name: out}})      # before its checks
    tag = f"phase {phase} {name}"
    n_pre = sum(per.values())
    check(prefill["flash_kinds"] == per
          and prefill["launches"]["flash_attention"] == n_pre
          and sum(prefill["launches"].values()) == n_pre,
          f"{tag}: one flash launch per attention call of the prefill "
          "(decoder, encoder, cross), nothing else")
    windows = {sig.split("/")[3] for sig in prefill["flash_signatures"]
               if sig.startswith("self/")}
    check(windows == {str(cfg.sliding_window)},
          f"{tag}: the decoder's flash calls carry the model's window")
    check(encode is None or (encode["flash_kinds"]["encoder"]
                             == cfg.encoder_layers
                             and encode["launches"]["flash_attention"]
                             == cfg.encoder_layers),
          f"{tag}: one flash launch per encoder layer for the cross caches")
    check(decode["flash_kinds"] == {"self": 0, "encoder": 0,
                                    "cross": steps * per["cross"]}
          and sum(decode["launches"].values()) == steps * per["cross"],
          f"{tag}: decode launched one flash per cross-attention layer a "
          "step (encdec) and nothing else")
    check(all(v["flash_variants"]["simt"] == 0
              for v in (prefill, decode, encode or prefill)),
          f"{tag}: every bf16 flash launch on the tensor-core kernel")
    check(gen.shape == (b, new),
          f"{tag}: every sequence generated its tokens")
    check(out["nonfinite_logits"] == 0, f"{tag}: finite logits")
    check(not checked or max(rows) <= PREFILL_DECODE_TOL,
          f"{tag}: decode from the prefill's caches gives the prefill's "
          f"logits at the last prompt position within {PREFILL_DECODE_TOL}")
    check(cfg.num_layers == get_config(name).num_layers
          or out["free_device_gib"] >= MIN_FREE_GIB,
          f"{tag}: the cut model leaves at least {MIN_FREE_GIB} GiB free")
    del batch, cross, caches
    torch.cuda.empty_cache()
    if then is not None:
        then(cfg, model)
    del model
    torch.cuda.empty_cache()
    return out, rec.calls


def flash_library(call, gqa: bool) -> tuple:
    """(fn, args) of scaled_dot_product_attention on one flash call (q, k,
    v, causal, window), a window as a boolean mask made outside the timed
    call."""
    q, k, v, causal, window = call
    mask = None
    if window is not None:
        qp = torch.arange(q.shape[2], device=q.device)[:, None]
        kp = torch.arange(k.shape[2], device=q.device)[None, :]
        mask = (kp <= qp) & (kp > qp - window)
    if not gqa:
        g = q.shape[1] // k.shape[1]
        k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    kw = {"enable_gqa": True} if gqa else {}
    return (lambda q_, k_, v_, m_: F.scaled_dot_product_attention(
        q_, k_, v_, attn_mask=m_, is_causal=causal and m_ is None, **kw)), \
        (q, k, v, mask)


def flash_bound(call) -> tuple:
    """(bytes / HBM rate, ops / peak rate of the inputs' type) in seconds
    of one flash call (q, k, v, causal, window): q, k, v read once and the
    output written once; 4 flops per (query head, visible key, head dim):
    every key non-causal, min(position + 1, window) causal."""
    q, k, _, causal, window = call
    b, h, sq, d = q.shape
    skv = k.shape[2]
    seen = float(np.minimum(np.minimum(np.arange(1, sq + 1), skv),
                            window or skv).sum()) if causal else sq * skv
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 \
        else CUDA_CORE_OPS_PER_S
    return nbytes / HBM_BYTES_PER_S, 4 * b * h * d * seen / rate


def phase_flash_families(calls: dict, outs: dict,
                         phase: str = "16") -> dict:
    """Phase 16's (or 20b's) kept flash calls (the first of each signature
    a model launched), each through the kernel and its plain version,
    compared at the dtype's tolerance, and timed with CUDA events beside
    its bound and scaled_dot_product_attention."""
    gqa = sdpa_gqa()
    out = {}
    for model, cs in calls.items():
        counts = {}
        for part in ("prefill", "encode", "decode"):
            for key, n in (outs[model][part] or {}).get(
                    "flash_signatures", {}).items():
                counts[key] = counts.get(key, 0) + n
        for sig, call in cs.items():
            kind, sq, skv, window = sig
            q, k = call[0], call[1]
            lib_fn, lib_args = flash_library(call, gqa)
            want = flash_plain(*call)
            err, ok = within(flash_any(*call), want, TOL[q.dtype])
            lib_err = within(lib_fn(*lib_args), want, TOL[q.dtype])[0]
            del want
            check(ok, f"phase {phase} {model} flash {kind} {sq}x{skv}: "
                  f"within {TOL[q.dtype]} of plain on the captured call")
            t_bytes, t_ops = flash_bound(call)
            key = "/".join(map(str, sig))
            out[f"{model} {kind} {sq}x{skv}"] = {
                "model": model, "kind": kind,
                "shape": [q.shape[0], q.shape[1], sq, q.shape[3],
                          k.shape[1], skv],
                "causal": call[3], "window": window,
                "dtype": str(q.dtype).split(".")[1],
                "variant": flash_kernel.variant(q.dtype, q.shape[3]),
                "launches": counts.get(key, 0), "max_abs_err": err,
                "ms": cuda_ms(flash_any, [call], 10),
                "device_ms": bracketed_ms(flash_any, [call], 5),
                "plain_ms": cuda_ms(flash_plain, [call], 2),
                "library_ms": cuda_ms(lib_fn, [lib_args], 10),
                "library_max_abs_err": lib_err,
                "bound_ms": 1e3 * max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            del lib_args
            torch.cuda.empty_cache()
    return out


def merge_families(kernels: list, by_shape: dict, outs: dict,
                   path: str = "moe, encdec and vlm serving (phase 16)"
                   ) -> None:
    """Give the flash row phase 16's (or 20b's) timed shapes beside its
    ``by_model`` entries, and count that phase's launches (prefill, cross
    caches, decode) in its ``launches``, ``launches_by_variant`` and
    ``by_path`` under ``path``.  No-op without phase 8's row."""
    for row in kernels:
        if row["name"] != "flash_attention":
            continue
        row.setdefault("by_model", {}).update(by_shape)
        n = sum(o["flash_launches"] for o in outs.values())
        row.setdefault("by_path", {})[path] = n
        row["launches"] += n
        for o in outs.values():
            for part in ("prefill", "encode", "decode"):
                for kind, k in (o[part] or {}).get("flash_variants",
                                                   {}).items():
                    row["launches_by_variant"][kind] += k


def merge_training(kernels: list, launched: dict, variants: dict) -> None:
    """Give the flash and fused-scan rows a ``by_path`` entry: the
    launches of the paths counted so far (serving and prefill) and
    phase 14's train steps, which the row's ``launches`` now include."""
    for row in kernels:
        name = row["name"]
        if name in launched:
            row["by_path"] = {"serving and prefill (phases 7, 11)":
                              row["launches"],
                              "train (phase 14)": launched[name]}
            row["launches"] += launched[name]
            if name == "flash_attention":
                for kind, n in variants.items():
                    row["launches_by_variant"][kind] += n


# ----------------------------------------------------------------------
# phase 17: the control plane, sweeps, drift, serving grid and cluster
# ----------------------------------------------------------------------
# 17a: one matrix of four cells at paper_keys // 64 keys, on the card, on
# the CPU, on the card in two spawned workers, and on the card with
# telemetry off; virtual seconds of its cells (the drift cell runs the
# rotate program's four phases instead)
IDENT_KEY_DIV, IDENT_LOAD_DIV, IDENT_PERIOD = 16, 4, 5.0
IDENT_DURATION, IDENT_WARMUP, IDENT_PHASE_S = 20.0, 2.0, 5.0
IDENT_WORKERS = 2
IDENT_READ_BATCH = 16
# 17b: bench_control's HHZS pi+knobs cell and bench_sharding's skew cell
# with the rebalancer (benchmarks/storage_exps.py), on the card
CONTROL_LOAD_DIV = 4                      # paper_keys // 4 keys
CONTROL_DURATION, CONTROL_WARMUP = 900.0, 90.0
SHARD_KEY_DIV, SHARD_LOAD_DIV, SHARD_PERIOD = 16, 8, 10.0
SHARD_DURATION = 160.0    # bench_sharding's 400 s cut, four dwell phases
SHARD_WARMUP = 16.0
MIX = WorkloadSpec("mix", read=0.5, update=0.5, alpha=0.9)
BULK_MIX = WorkloadSpec("bulkmix", read=0.5, update=0.5, alpha=0.9)
UNIFORM_MIX = WorkloadSpec("shmix", read=0.5, update=0.5, alpha=0.01)


@dataclasses.dataclass
class CellList(ScenarioMatrix):
    """A scenario matrix over an explicit tuple of resolved cells of any
    kind (multi-tenant, drift, sharded single-stream): each cell carries
    its own tenants, program, shards and fault, the matrix the sizing,
    store factory, telemetry and device they share."""

    picked: tuple = ()

    def cells(self) -> list:
        return list(self.picked)


def control_probe(factory) -> dict:
    """bench_control's anchors from a seeded closed-loop probe of a B3
    store: the mix's service rate, the protected tenant's p99 target
    (1.5x the probe's p99) and the debt threshold (1.5x the standing
    backlog plus 256 MiB at scale)."""
    probe = factory("B3", 20)
    pr = run_workload(probe, MIX, n_ops=2000, n_keys=probe.n_keys)
    return {"n_keys": probe.n_keys, "svc": max(pr.throughput, 1e-6),
            "slo": round(1.5 * pr.latency_p["p99"], 4),
            "debt": round(1.5 * float(probe.tree.compaction_debt())
                          + 256 * MiB / SCALE, 1)}


def control_tenants(a: dict) -> tuple:
    """bench_control's tenants and its pi+knobs feedback policy: "prot"
    (Poisson at 0.25x the probe's rate, p99 target) and "bulk" (1.2x,
    its target 1.5x prot's) under the PI law over all four knobs."""
    bulk = round(1.2 * a["svc"], 4)
    mix = (TenantSpec("prot", MIX, PoissonArrivals(round(0.25 * a["svc"],
                                                         4)),
                      protected=True, slo_p99=a["slo"]),
           TenantSpec("bulk", BULK_MIX, PoissonArrivals(bulk),
                      slo_p99=round(1.5 * a["slo"], 4)))
    policy = AdmissionConfig(
        policy="feedback", bucket_rates={"bulk": (bulk, 20.0)},
        debt_threshold=a["debt"], label="pi+knobs", queue_threshold=8,
        feedback_interval=2.5, feedback_window=60,
        feedback_controller="pi", feedback_kp=2.0, feedback_ki=0.5,
        feedback_smooth=1.0, feedback_rise=0.08,
        feedback_knobs=("admission", "compaction", "migration", "cache"))
    return mix, policy


def hot_spec(rate: float, duration: float, n_keys: int) -> WorkloadSpec:
    """bench_sharding's drifting hot range: four dwell phases a run."""
    return WorkloadSpec("shhot", read=0.5, update=0.5, alpha=0.99,
                        dist="hotspot",
                        hotspot_period=int(rate * duration / 4),
                        hotspot_step=n_keys // 4)


def identity_cells(a: dict) -> tuple:
    """17a's cells: bench_control's two tenants under pi+knobs, a rotate
    drift program, a 2-shard range cluster whose shard 1 crashes halfway,
    and a 4-shard range cluster with the rebalancer on a hot range."""
    n, svc = a["n_keys"], a["svc"]
    mix, policy = control_tenants(a)
    tenants = ScenarioMatrix(
        schemes=["HHZS"], workloads=[], arrivals=[], tenants=[mix],
        policies=[policy], drift_programs=[build_program(
            "rotate", svc=round(svc, 4), n_keys=n, phase_s=IDENT_PHASE_S)])
    crash = ScenarioMatrix(
        schemes=["HHZS"], workloads=[UNIFORM_MIX],
        arrivals=[PoissonArrivals(round(svc, 4))], shards=[2],
        routing="range", faults=[FaultSpec(
            name="crash-s1", crash_at=IDENT_DURATION / 2, crash_shard=1,
            recovery_slo_s=10.0)])
    rate = round(2.0 * svc, 4)
    skew = ScenarioMatrix(
        schemes=["HHZS"], workloads=[hot_spec(rate, IDENT_DURATION, n)],
        arrivals=[PoissonArrivals(rate)], shards=[4], routing="range",
        rebalance=[True])
    return tuple(tenants.cells() + crash.cells() + skew.cells())


def identity_matrix(cells: tuple, dev: str, telemetry: bool) -> CellList:
    return CellList(
        schemes=[], workloads=[], arrivals=[], picked=cells,
        duration=IDENT_DURATION, warmup=IDENT_WARMUP, max_concurrency=16,
        key_div=IDENT_KEY_DIV, read_batch=IDENT_READ_BATCH,
        db_factory=GridDBFactory(key_div=IDENT_KEY_DIV,
                                 load_div=IDENT_LOAD_DIV,
                                 rebalance_period=IDENT_PERIOD,
                                 torch_device=dev),
        telemetry=telemetry, torch_device=dev)


class ProbeStage:
    """Times every tree's probe stage (``LSMTree._probe_slots`` and
    ``_probe_pairs_real``, a call inside another once) while it is
    entered, across the trees a cell makes, crashes and reopens."""

    NAMES = ("_probe_slots", "_probe_pairs_real")

    def __init__(self):
        self.seconds, self._depth = 0.0, 0
        self._orig = {n: getattr(LSMTree, n) for n in self.NAMES}

    def __enter__(self):
        stage = self

        def timed(fn):
            def call(*a, **kw):
                if stage._depth:
                    return fn(*a, **kw)
                stage._depth, t0 = 1, time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    stage.seconds += time.perf_counter() - t0
                    stage._depth = 0
            return call
        for n, fn in self._orig.items():
            setattr(LSMTree, n, timed(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self._orig.items():
            setattr(LSMTree, n, fn)


class KeepStores:
    """A store factory that keeps every store it makes."""

    def __init__(self, factory):
        self.factory, self.made = factory, []

    def __call__(self, *args, **kw):
        db = self.factory(*args, **kw)
        self.made.append(db)
        return db


def resident_bytes(db) -> list:
    """Bytes of each shard's store image resident on the card."""
    out = []
    for shard in getattr(db, "shards", [db]):
        image = shard.tree._store_image()
        out.append(image.resident.n_words * 4
                   if image.resident is not None else 0)
    return out


def run_identity(cells: tuple, dev: str, telemetry: bool,
                 workers: int = 0) -> tuple:
    """(rows as JSON, launches, wall seconds) of the 17a matrix, the
    launch counts zeroed just before and read just after (workers launch
    in their own processes)."""
    kernel.reset_launches()
    t0 = time.perf_counter()
    rows = run_sweep(identity_matrix(cells, dev, telemetry), out=None,
                     workers=workers, verbose=False)
    sync(dev)
    return (json.dumps(rows, sort_keys=True), dict(kernel.launches),
            time.perf_counter() - t0)


SERVING_WL = ServingWorkload(name="chat", prompt_med=24, prompt_max=64,
                             out_med=12, out_max=32, pause_prob=0.02,
                             pause_mean=2.0, slo_ttft=2.0)


def serving_verify(dev: str) -> tuple:
    """One serving-grid cell (HHZS tiering, Poisson at 2 sequences/s, a
    6-zone device tier) with its KV pages materialized on ``dev``, every
    resident page re-read after every decode step: (rows and stats as
    JSON, the device tier's device, wall seconds)."""
    built, orig = [], ServingPool.build

    def build(pool, *args, **kw):
        built.append(orig(pool, *args, **kw))
        return built[-1]
    ServingPool.build = build
    try:
        t0 = time.perf_counter()
        res = run_serving(
            [TenantSpec("t0", SERVING_WL,
                        serving_arrivals(("poisson",), 2.0)[0],
                        protected=True, slo_p99=2.0)],
            "hhzs", pool=ServingPool(hbm_zones=6, host_zones=48),
            duration=25.0, warmup=5.0, seed=3, materialize=True,
            verify="step", torch_device=dev)
        sync(dev)
        wall = time.perf_counter() - t0
    finally:
        ServingPool.build = orig
    return (json.dumps([res.rows, res.stats], sort_keys=True),
            built[0][0].k.device.type, wall)


def phase_control_identity(paper_keys: int,
                           card_dev: str = "cuda") -> dict:
    """17a: the matrix's rows on the card, on the CPU, on the card in
    spawned workers and on the card with telemetry off: all byte-equal;
    the card's run launched the pairs kernel, the CPU's none; then the
    serving cell on the card and the CPU."""
    t0 = time.perf_counter()
    anchors = control_probe(GridDBFactory(key_div=IDENT_KEY_DIV,
                                          load_div=IDENT_LOAD_DIV,
                                          torch_device=card_dev))
    check(anchors["n_keys"] == paper_keys // 64,
          "phase 17a: paper_keys // 64 keys a store")
    cells = identity_cells(anchors)
    probe_s = time.perf_counter() - t0
    runs = {"card": run_identity(cells, card_dev, True),
            "cpu": run_identity(cells, "cpu", True),
            "card_workers": run_identity(cells, card_dev, True,
                                         IDENT_WORKERS),
            "card_telemetry_off": run_identity(cells, card_dev, False)}
    rows = {k: r[0] for k, r in runs.items()}
    serving = {k: serving_verify(dev)
               for k, dev in (("card", card_dev), ("cpu", "cpu"))}
    parsed = json.loads(rows["card"])
    out = {"n_keys": anchors["n_keys"], "anchors": anchors,
           "probe_s": probe_s, "cells": [c.name for c in cells],
           "rows": len(parsed), "row_bytes": len(rows["card"]),
           "rows_identical": len(set(rows.values())) == 1,
           "launches": {k: r[1] for k, r in runs.items()},
           "wall_s": {k: r[2] for k, r in runs.items()},
           "splits": [len(r.get("splits", [])) for r in parsed
                      if "shards" in r and "shard" not in r],
           "crash": [r.get("crash") for r in parsed if r.get("crash")],
           "serving_rows_identical": serving["card"][0] == serving["cpu"][0],
           "serving_device_tier": {d: v[1] for d, v in serving.items()},
           "serving_wall_s": {d: v[2] for d, v in serving.items()}}
    check(len(cells) == 4, "phase 17a: four cells")
    check(out["rows_identical"],
          "phase 17a: rows equal on card, CPU, spawned workers, and with "
          "telemetry off, byte for byte")
    check(runs["card"][1]["bloom_probe_pairs"] > 0,
          "phase 17a: the card's run launched the pairs kernel")
    check(not any(runs["cpu"][1].values()),
          "phase 17a: the CPU's run launched no kernel")
    check(out["crash"] and out["splits"] and max(out["splits"]) > 0,
          "phase 17a: the crash fired and the rebalancer moved a range")
    check(out["serving_rows_identical"]
          and out["serving_device_tier"] == {
              "card": torch.device(card_dev).type, "cpu": "cpu"},
          "phase 17a: the verify-step serving cell, its device tier on "
          "the card, gives the CPU's rows and stats")
    return out


def run_cell(matrix, cell, dev) -> dict:
    """One cell on ``dev`` with the launch counts zeroed just before and
    read just after: rows, launches, the probe stage's host seconds and
    the stores' resident image bytes."""
    keep = KeepStores(matrix.db_factory)
    matrix.db_factory = keep
    with ProbeStage() as stage:
        kernel.reset_launches()
        t0 = time.perf_counter()
        _, rows = matrix.run_cell(cell)
        sync(dev)
        wall = time.perf_counter() - t0
        launched = dict(kernel.launches)
    (db,) = keep.made
    agg = [r for r in rows if "shard" not in r]
    return {"cell": cell.name, "wall_s": wall, "launches": launched,
            "probe_stage_s": stage.seconds,
            "probe_stage_share": stage.seconds / wall,
            "resident_image_bytes": resident_bytes(db),
            "throughput": sum(r["throughput"] for r in agg),
            "goodput": sum(r.get("goodput") or 0.0 for r in agg),
            "p99_s": {r.get("tenant") or "all": r["latency_p"]["p99"]
                      for r in agg},
            "rebalance_moves": len(getattr(db, "splits", [])),
            "moved_keys": sum(sp.get("moved_keys", 0)
                              for sp in getattr(db, "splits", [])),
            "rows": rows}


def phase_control_main(paper_keys: int, dev: str = "cuda") -> dict:
    """17b: bench_control's HHZS pi+knobs cell at paper_keys // 4 keys (16
    servers, CONTROL_DURATION virtual seconds) and bench_sharding's skew
    cell (4 range shards, the rebalancer every 10 s, a hot range at 9x
    the probe's rate, SHARD_DURATION virtual seconds), each on the card."""
    out = {}
    t0 = time.perf_counter()
    factory = GridDBFactory(key_div=1, load_div=CONTROL_LOAD_DIV,
                            torch_device=dev)
    anchors = control_probe(factory)
    mix, policy = control_tenants(anchors)
    matrix = ScenarioMatrix(
        schemes=["HHZS"], workloads=[], arrivals=[], tenants=[mix],
        policies=[policy], ssd_zone_budgets=[20],
        duration=CONTROL_DURATION, warmup=CONTROL_WARMUP,
        max_concurrency=16, db_factory=factory, telemetry=True,
        torch_device=dev)
    (cell,) = matrix.cells()
    out["control"] = {"n_keys": anchors["n_keys"], "anchors": anchors,
                      "probe_s": time.perf_counter() - t0,
                      "virtual_s": [CONTROL_DURATION, CONTROL_WARMUP],
                      **run_cell(matrix, cell, dev)}
    check(out["control"]["n_keys"] == paper_keys // CONTROL_LOAD_DIV,
          "phase 17b control: paper_keys // 4 keys")
    out["control"]["prot_p99_s"] = out["control"]["p99_s"]["prot"]
    t0 = time.perf_counter()
    factory = GridDBFactory(key_div=SHARD_KEY_DIV, load_div=SHARD_LOAD_DIV,
                            rebalance_period=SHARD_PERIOD,
                            torch_device=dev)
    probe = factory("HHZS", 20)
    svc = max(run_workload(probe, UNIFORM_MIX, n_ops=2000,
                           n_keys=probe.n_keys).throughput, 1e-6)
    rate = round(9.0 * svc, 4)
    matrix = ScenarioMatrix(
        schemes=["HHZS"], ssd_zone_budgets=[20],
        workloads=[hot_spec(rate, SHARD_DURATION, probe.n_keys)],
        arrivals=[PoissonArrivals(rate)], shards=[4], routing="range",
        rebalance=[True], duration=SHARD_DURATION, warmup=SHARD_WARMUP,
        key_div=SHARD_KEY_DIV, db_factory=factory, torch_device=dev)
    (cell,) = matrix.cells()
    out["sharding"] = {"n_keys": probe.n_keys, "svc": svc, "rate": rate,
                       "probe_s": time.perf_counter() - t0,
                       "virtual_s": [SHARD_DURATION, SHARD_WARMUP],
                       **run_cell(matrix, cell, dev)}
    del probe
    for name, r in out.items():
        rows = r.pop("rows")
        r["row_bytes"] = len(json.dumps(rows))
        check(r["launches"]["bloom_probe_pairs"] > 0,
              f"phase 17b {name}: the cell's reads launched the pairs "
              "kernel")
        check(all(b > 0 for b in r["resident_image_bytes"]),
              f"phase 17b {name}: every shard's filters resident on the "
              "card")
        check(all(np.isfinite(v) for v in r["p99_s"].values()),
              f"phase 17b {name}: finite latencies")
    check(out["sharding"]["rebalance_moves"] > 0,
          "phase 17b sharding: the rebalancer moved a range")
    return out


def merge_store_paths(kernels: list, paths: dict) -> None:
    """Give the two Bloom rows a ``by_path`` entry: phase 3's main path,
    which the row's ``launches`` held, and each of phase 17's paths,
    which it now includes."""
    for row in kernels:
        name = row["name"]
        if name not in kernel.launches:
            continue
        row["by_path"] = {"YCSB-C open loop (phase 3)": row["launches"]}
        for path, launched in paths.items():
            row["by_path"][path] = launched[name]
            row["launches"] += launched[name]


# ----------------------------------------------------------------------
# phase 18: the multi-device layer, OLMoE's prefill through the sharded MoE
# ----------------------------------------------------------------------
MESH_IDENTITY = ("olmoe-1b-7b", 2, 2, 64)   # model, layers, prompts, tokens
MESH_MAIN = ("olmoe-1b-7b", None, 4, 2048)
NO_DROP_FACTOR = 8.0          # no pair drops at 2 x 64 tokens and E / k
MESH_TOL = 1e-4


def init_group() -> None:
    """One rank: gloo for CPU tensors, NCCL for the card's, over an
    in-process store.  A group that does not come up raises."""
    dist.init_process_group(backend="cpu:gloo,cuda:nccl",
                            store=dist.HashStore(), rank=0, world_size=1)


def sharded_prefill(cfg, mesh):
    """``make_prefill_step`` with the sequence-sharded constraint on
    ``mesh``: every MoE layer through ``moe_shard_map``."""
    return make_prefill_step(cfg, ParallelConfig(seq_shard_activations=True),
                             activation_constraint(mesh, seq_shard=True))


def mesh_run(model, batch: dict, step, dev) -> dict:
    """One prefill of ``step`` on ``dev``, the counts zeroed just before
    and read just after: logits, the MoE's experts and kept slots of every
    call, kernel launches and collectives."""
    tb = to_dev(batch, dev)
    reset_model_launches()
    moe_sharded.reset_launches()
    with ModelRecorder(routes=True) as rec:
        logits = step(model, tb)
        sync(dev)
    return {"logits": logits.float().cpu(), "experts": rec.experts,
            "kept": rec.kept, "kinds": dict(rec.kinds),
            "launches": model_launches(),
            "variants": dict(flash_kernel.variant_launches),
            "collectives": dict(moe_sharded.launches),
            "dropped": sum(int((~k).sum()) for k in rec.kept)}


def phase_mesh_identity(card_dev: str = "cuda") -> dict:
    """Phase 18a: OLMoE-1B-7B at full width cut to 2 layers, fp32 (weights
    drawn on the card, copied to the CPU), TF32 off.  The sharded prefill
    at the default capacity factor (pairs drop) on the card's mesh and on
    a CPU mesh of the same group: routes, kept slots and drops identical,
    logits within MESH_TOL; at NO_DROP_FACTOR the sharded prefill on the
    card against the plain one on the card.  Launches by kind: one flash
    a layer (CUDA-core: fp32), two all-to-alls and four all-gathers a MoE
    layer, none of them on the plain path."""
    name, layers, b, t = MESH_IDENTITY
    cfg = family_cfg(name, layers)
    t0 = time.perf_counter()
    card_model = init_model(cfg, seed=0, device=card_dev,
                            dtype=torch.float32)
    cpu_model = copy.deepcopy(card_model).to("cpu")
    init_s = time.perf_counter() - t0
    meshes = {card_dev: make_local_mesh(1, torch.device(card_dev).type),
              "cpu": make_local_mesh(1, "cpu")}
    batch = family_batch(cfg, b, t, 15)
    runs = {dev: mesh_run(model, batch, sharded_prefill(cfg, meshes[dev]),
                          dev)
            for dev, model in ((card_dev, card_model), ("cpu", cpu_model))}
    nd = dataclasses.replace(cfg, capacity_factor=NO_DROP_FACTOR)
    sharded = mesh_run(card_model, batch,
                       sharded_prefill(nd, meshes[card_dev]), card_dev)
    plain = mesh_run(card_model, batch, make_prefill_step(nd), card_dev)
    card, cpu = runs[card_dev], runs["cpu"]
    n = cfg.num_layers
    want_coll = {"all_gather": 4 * n, "all_to_all": 2 * n,
                 "reduce_scatter": 0}
    r = {"model": cfg.name, "layers": n, "prefill_tokens": [b, t],
         "mesh": list(meshes[card_dev].shape), "init_s": init_s,
         "capacity": [cfg.capacity_factor, max(int(
             cfg.capacity_factor * b * t * cfg.top_k / cfg.num_experts), 1)],
         "card_vs_cpu_rel_err": rel_err(card["logits"], cpu["logits"]),
         "moe_calls": len(card["experts"]),
         "experts_identical": len(card["experts"]) == len(cpu["experts"])
         and all(torch.equal(a, c) for a, c in zip(card["experts"],
                                                   cpu["experts"])),
         "kept_identical": len(card["kept"]) == len(cpu["kept"])
         and all(torch.equal(a, c) for a, c in zip(card["kept"],
                                                   cpu["kept"])),
         "dropped_pairs": {"card": card["dropped"], "cpu": cpu["dropped"]},
         "launches": {"card": card["launches"], "cpu": cpu["launches"]},
         "flash_kinds": card["kinds"], "flash_variants": card["variants"],
         "collectives": {"card": card["collectives"],
                         "cpu": cpu["collectives"]},
         "no_drop": {"capacity_factor": NO_DROP_FACTOR,
                     "sharded_vs_plain_rel_err": rel_err(sharded["logits"],
                                                         plain["logits"]),
                     "dropped_pairs": {"sharded": sharded["dropped"],
                                       "plain": plain["dropped"]},
                     "collectives": {"sharded": sharded["collectives"],
                                     "plain": plain["collectives"]}}}
    emit(phase18a=r)                      # before its checks
    tag = "phase 18a"
    check(r["card_vs_cpu_rel_err"] <= MESH_TOL,
          f"{tag}: sharded prefill logits on the card within 1e-4 of the "
          "CPU mesh's")
    check(r["experts_identical"] and r["kept_identical"]
          and r["moe_calls"] == n and card["dropped"] == cpu["dropped"] > 0,
          f"{tag}: every MoE call's experts, kept slots and drops "
          "identical on the card and the CPU, pairs dropped")
    check(card["kinds"]["self"] == n and card["launches"]["flash_attention"]
          == n and sum(card["launches"].values()) == n
          and card["variants"] == {"mma": 0, "simt": n},
          f"{tag}: one flash launch a layer (fp32: CUDA-core), nothing "
          "else")
    check(not any(cpu["launches"].values()),
          f"{tag}: the CPU run launched no kernel")
    check(card["collectives"] == cpu["collectives"] == want_coll
          and sharded["collectives"] == want_coll,
          f"{tag}: two all-to-alls and four all-gathers a MoE layer")
    check(not any(plain["collectives"].values()),
          f"{tag}: the plain prefill made no collective call")
    check(r["no_drop"]["sharded_vs_plain_rel_err"] <= MESH_TOL
          and sharded["dropped"] == plain["dropped"] == 0,
          f"{tag}: at capacity factor {NO_DROP_FACTOR} no pair dropped and "
          "the sharded prefill within 1e-4 of the plain one on the card")
    del card_model, cpu_model
    torch.cuda.empty_cache()
    return r


MOE_SPANS = {"dispatch": (moe_sharded, "_topk_dispatch"),
             "experts": (moe_sharded, "_experts"),
             "combine": (moe_sharded, "_combine"),
             "all_gather": (moe_sharded, "_all_gather"),
             "all_to_all": (moe_sharded, "_all_to_all")}


def phase_mesh_main(dev: str = "cuda", unsharded: dict = None) -> dict:
    """Phase 18b: OLMoE-1B-7B at full width and depth, bf16 random weights
    (seed 0) made on the card, ``make_prefill_step`` through the sharded
    MoE on the (1, 1) NCCL mesh, 4 prompts of 2,048: the first call with
    the counts zeroed before and read after (one flash a layer on the
    tensor-core kernel, two all-to-alls a MoE layer, pairs dropped), a
    second timed, a third under the profiler with the sharded MoE's
    dispatch, experts, combine and collectives bracketed by CUDA events
    (``Spans``; NCCL on a group of one rank copies with the copy engine
    and launches no kernel of its own): device time by operation,
    flash's, the busy share; beside phase 16's unsharded prefill of the
    same model when it ran."""
    name, layers, b, t = MESH_MAIN
    cfg = family_cfg(name, layers)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    mesh = make_local_mesh(1, "cuda")
    step = sharded_prefill(cfg, mesh)
    batch = to_dev(family_batch(cfg, b, t, 16), dev, L.DTYPE)
    torch.cuda.reset_peak_memory_stats()
    reset_model_launches()
    moe_sharded.reset_launches()
    with ModelRecorder() as rec:
        t0 = time.perf_counter()
        logits = step(model, batch)
        nonfinite = int((~torch.isfinite(logits)).sum())
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        dropped, pairs = int(rec.dropped), rec.pairs
        kinds = dict(rec.kinds)
    launched, variants = model_launches(), dict(flash_kernel.variant_launches)
    collectives = dict(moe_sharded.launches)
    t0 = time.perf_counter()
    step(model, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    with Spans(MOE_SPANS) as spans:
        ops = device_ops(lambda: step(model, batch))
    split = spans.summary()
    device = sum(ms for _, ms, _ in ops)

    def part(hits) -> dict:
        ms = sum(ms for _, ms, _ in hits)
        return {"device_ms": ms, "launches": sum(n for _, _, n in hits),
                "share": ms / device}
    for v in split.values():
        v["share"] = v["device_ms"] / device
    e, k = cfg.num_experts, cfg.top_k
    out = {"model": cfg.name, "layers": cfg.num_layers,
           "params": sum(p.numel() for p in model.parameters()),
           "mesh": list(mesh.shape), "batch": [b, t], "load_s": load_s,
           "first_prefill_s": first_s, "prefill_s": prefill_s,
           "tokens_per_s": b * t / prefill_s,
           "capacity_per_expert": max(int(cfg.capacity_factor * b * t * k
                                          / e), 1),
           "moe_pairs": pairs, "dropped_pairs": dropped,
           "dropped_share": dropped / pairs if pairs else 0.0,
           "launches": launched, "flash_variants": variants,
           "flash_kinds": kinds, "collectives": collectives,
           "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
           "prefill_device_ms": device,
           "busy_share": device / (1e3 * prefill_s),
           "moe_spans": split,
           "nccl_kernels": part([o for o in ops if "nccl" in o[0].lower()]),
           "device_copies": part([o for o in ops if "Memcpy DtoD" in o[0]]),
           "flash": part([o for o in ops if "flash_fwd" in o[0]]),
           "gemms_all": part([o for o in ops if is_gemm(o[0])]),
           "top_ops": [{"op": key[:120], "device_ms": ms, "count": n,
                        "share": ms / device}
                       for key, ms, n in ops[:TOP_OPS]],
           "nonfinite_logits": nonfinite}
    if unsharded is not None:
        out["phase16_unsharded"] = {
            key: unsharded[key] if key in unsharded
            else unsharded["prefill"][key]
            for key in ("prefill_device_ms", "prefill_busy_share",
                        "seconds", "tokens_per_s", "dropped_share")}
    emit(phase18b=out)                    # before its checks
    tag = "phase 18b"
    n = cfg.num_layers
    check(kinds["self"] == n and launched["flash_attention"] == n
          and sum(launched.values()) == n and variants == {"mma": n,
                                                           "simt": 0},
          f"{tag}: one flash launch a layer on the tensor-core kernel, "
          "nothing else")
    check(collectives["all_to_all"] == 2 * n,
          f"{tag}: two all-to-alls a MoE layer")
    check(nonfinite == 0 and logits.shape == (b, cfg.vocab_size),
          f"{tag}: finite next-token logits for every prompt")
    check(split["experts"]["calls"] == n
          and split["all_to_all"]["calls"] == 2 * n,
          f"{tag}: the profiled prefill ran the experts and two "
          "all-to-alls on every layer")
    del model, batch, logits
    torch.cuda.empty_cache()
    return out


def merge_mesh(kernels: list, out: dict) -> None:
    """Count phase 18b's flash launches in the flash row's ``launches``,
    ``launches_by_variant`` and ``by_path``.  No-op without the row."""
    for row in kernels:
        if row["name"] != "flash_attention":
            continue
        n = out["launches"]["flash_attention"]
        row.setdefault("by_path", {})[
            "OLMoE prefill through the sharded MoE (phase 18)"] = n
        row["launches"] += n
        for kind, k in out["flash_variants"].items():
            row["launches_by_variant"][kind] += k


# ----------------------------------------------------------------------
# phase 19: the train loop on DTensor state, and one dry-run cell
# ----------------------------------------------------------------------
SHARDED_MAIN = "qwen3-1.7b"      # full width and depth, phase 13's batch
SHARDED_STEPS = 3
SHARDED_CKPT_STEPS = 2           # the checkpoint files, at the smoke config
DRYRUN_CELL = ("qwen3-1.7b", "train_4k", "single")


def card_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """``rel_err`` computed where the tensors are (one leaf of a 1.7B
    state is too large to copy to the host by the hundred)."""
    g, w = got.float(), want.float()
    scale = float(w.abs().max())
    return float((g - w).abs().max()) / (scale or 1.0)


def bf16_line(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor's bit patterns on one integer line: adjacent numbers
    1 apart, -0 and +0 equal."""
    b = t.view(torch.int16).int()
    return torch.where(b < 0, -32768 - b, b)


def bf16_steps(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest distance in bf16 steps between two bf16 tensors."""
    return int((bf16_line(got) - bf16_line(want)).abs().max())


def local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def loop_run(cfg, dev, steps: int, ckpt_dir=None) -> tuple:
    """``train_loop`` for ``steps`` steps of phase 13's batch and sequence,
    logging every step, the counts zeroed just before and read just
    after, the peak device memory reset before: (its output, a record)."""
    stamps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_model_launches()
    t0 = time.perf_counter()
    out = train_loop(cfg, steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     tc=TRAIN_TC, log_every=1, ckpt_dir=ckpt_dir,
                     save_every=steps, device=dev,
                     log=lambda msg: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    later = stamps[-1] - stamps[0]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    rec = {"wall_s": time.perf_counter() - t0,
           "init_and_first_step_s": stamps[0] - t0,
           "step_s": [b - a for a, b in zip(stamps, stamps[1:])],
           "mean_step_s_2_on": later / (len(stamps) - 1),
           "tokens_per_s_2_on": tokens * (len(stamps) - 1) / later,
           "metrics": out["metrics"], "launches": model_launches(),
           "flash_variants": dict(flash_kernel.variant_launches),
           "flash_bwd_variants": dict(flash_kernel.bwd_variant_launches),
           "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}
    return out, rec


def leaves(state: dict) -> dict:
    """Every leaf of a train state by (field, name), local tensors."""
    out = {("params", n): local(p.detach())
           for n, p in state["model"].named_parameters()}
    for f in ("master", "mu", "nu"):
        out.update({(f, n): local(t) for n, t in
                    getattr(state["opt"], f).items()})
    out[("step", "")] = local(state["opt"].step)
    return out


def same_files(a: Path, b: Path) -> bool:
    """Two checkpoint dirs' manifests and npz arrays equal, byte for
    byte."""
    if (a / "manifest.json").read_text() != (b / "manifest.json").read_text():
        return False
    with np.load(a / "arrays.npz") as x, np.load(b / "arrays.npz") as y:
        return x.files == y.files and all(
            x[k].dtype == y[k].dtype and x[k].tobytes() == y[k].tobytes()
            for k in x.files)


def phase_sharded_train(dev: str = "cuda") -> dict:
    """Phase 19a: ``train_loop`` at Qwen3-1.7B's full width and depth on
    one card, first with no process group (one device), then on DTensor
    state over the (1, 1) mesh of a one-rank NCCL group, from the same
    seed, state and batches: every step's loss, grad norm and lr within
    1e-4, the final moments within 1e-4 of each tensor's largest and the
    parameters within one bf16 step; the flash launches of each loop
    counted (two forward a layer a step: the forward and its recompute;
    one backward); step
    time, tokens/s, peak memory and, from one more profiled step of the
    sharded state, the busy share.  Then both loops at the smoke config,
    each saving its last step: the files byte-identical, and each
    restores in the other's layout with every leaf equal."""
    cfg = get_config(SHARDED_MAIN)
    small = get_config(SHARDED_MAIN).smoke()
    torch.cuda.empty_cache()
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    plain_out, plain = loop_run(cfg, dev, SHARDED_STEPS)
    plain_small, _ = loop_run(small, dev, SHARDED_CKPT_STEPS, tmp / "plain")
    init_group()
    try:
        sharded_out, sharded = loop_run(cfg, dev, SHARDED_STEPS)
        want = train_launches(cfg, SHARDED_STEPS, 1)
        rec = {"model": cfg.name, "layers": cfg.num_layers,
               "params": sum(p.numel() for p in
                             plain_out["state"]["model"].parameters()),
               "batch": [TRAIN_BATCH, TRAIN_SEQ], "steps": SHARDED_STEPS,
               "mesh": [1, 1], "one_device": plain, "sharded": sharded,
               "expected_launches": want}
        rel = [abs(got[k] - ref[k]) / abs(ref[k])
               for (_, got), (_, ref) in zip(sharded["metrics"],
                                             plain["metrics"])
               for k in ("loss", "grad_norm", "lr")]
        a, b = leaves(sharded_out["state"]), leaves(plain_out["state"])
        placed = all(isinstance(t, DTensor) for t in
                     sharded_out["state"]["model"].parameters())
        rec["metrics_rel_err"] = max(rel)
        rec["moments_rel_err"] = max(card_rel_err(a[k], b[k]) for k in b
                                     if k[0] in ("mu", "nu"))
        rec["masters_rel_err"] = max(card_rel_err(a[k], b[k]) for k in b
                                     if k[0] == "master")
        rec["param_bf16_steps"] = max(bf16_steps(a[k], b[k]) for k in b
                                      if k[0] == "params")
        rec["bit_equal"] = all(torch.equal(a[k], b[k]) for k in b)
        del plain_out, a, b
        torch.cuda.empty_cache()
        mesh = make_local_mesh(1, dev)
        step = make_train_step(cfg, TRAIN_TC, ParallelConfig(
            seq_shard_activations=False), activation_constraint(mesh))
        batch = to_device(SyntheticLM(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
                          .batch_at(SHARDED_STEPS), torch.device(dev), mesh)
        holder = {"state": sharded_out["state"]}

        def one():
            holder["state"], m = step(holder["state"], batch)
            holder["loss"] = m["loss"]
        device_ms = device_busy_ms(one)
        rec["profiled_step"] = {
            "device_ms": device_ms, "loss": float(holder["loss"]),
            "busy_share": device_ms / (1e3 * sharded["mean_step_s_2_on"])}
        del sharded_out, holder, batch
        torch.cuda.empty_cache()
        sharded_small, _ = loop_run(small, dev, SHARDED_CKPT_STEPS,
                                    tmp / "sharded")
        like = state_shapes(small)
        specs = (mesh, state_specs(mesh, small, like))
        last = f"step_{SHARDED_CKPT_STEPS}"
        from_sharded, _ = ckpt.restore(like, str(tmp / "sharded"),
                                       device=dev)
        from_plain, _ = ckpt.restore(like, str(tmp / "plain"), device=dev,
                                     shardings=specs)
        pairs = [(leaves(from_sharded), leaves(sharded_small["state"])),
                 (leaves(from_plain), leaves(plain_small["state"]))]
        rec["checkpoint"] = {
            "model": small.name, "step": SHARDED_CKPT_STEPS,
            "files_byte_identical": same_files(tmp / "plain" / last,
                                               tmp / "sharded" / last),
            "restores_in_the_other": all(
                torch.equal(g[k], w[k]) for g, w in pairs for k in w),
            "restored_sharded": all(isinstance(p, DTensor) for p in
                                    from_plain["model"].parameters())}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    emit(phase19a=rec)                  # before its checks
    check(placed, "phase 19a: the sharded loop's parameters are DTensors")
    check(len(sharded["metrics"]) == len(plain["metrics"]) == SHARDED_STEPS
          and rec["metrics_rel_err"] <= TRAIN_TOL,
          "phase 19a: every step's loss, grad norm and lr within 1e-4 of "
          "the one-device loop's")
    check(rec["moments_rel_err"] <= TRAIN_TOL
          and rec["masters_rel_err"] <= TRAIN_TOL,
          "phase 19a: moments and masters within 1e-4 of each tensor's "
          "largest")
    check(rec["param_bf16_steps"] <= 1,
          "phase 19a: parameters within one bf16 step")
    for name, r in (("one-device", plain), ("sharded", sharded)):
        check(r["launches"] == {**{k: 0 for k in r["launches"]}, **want},
              f"phase 19a: the {name} loop launched flash twice a layer a "
              "step (forward and recompute), its backward once, and "
              "nothing else")
        check(r["flash_variants"] == {"mma": want["flash_attention"],
                                      "simt": 0}
              and r["flash_bwd_variants"] == {
                  "mma": want["flash_attention_bwd"], "simt": 0},
              f"phase 19a: the {name} loop's flash, forward and backward, "
              "on the tensor-core kernels")
    check(np.isfinite(rec["profiled_step"]["loss"]),
          "phase 19a: the profiled sharded step's loss is finite")
    ck = rec["checkpoint"]
    check(ck["files_byte_identical"],
          "phase 19a: the sharded loop's checkpoint is the one-device "
          "loop's, byte for byte")
    check(ck["restores_in_the_other"] and ck["restored_sharded"],
          "phase 19a: each loop's checkpoint restores in the other's layout "
          "with every leaf equal")
    return rec


def phase_dryrun_cell() -> dict:
    """Phase 19b: the dry run's ``lower_cell`` for Qwen3-1.7B x train_4k
    on the 16 x 16 production mesh of a fake group of 256 ranks (this
    process rank 0, fake tensors on the host: no card, no exchange)."""
    arch, shape, mesh_name = DRYRUN_CELL
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device_type=dryrun.DEVICE)
        rec = dryrun.lower_cell(arch, shape, mesh, mesh_name)
    emit(phase19b=rec)                  # before its checks
    rl = rec["roofline"]
    check(rec["status"] == "ok" and rec["chips"] == 256,
          "phase 19b: the 16 x 16 cell traced")
    check(rl["flops_per_device"] * 256 >= rl["model_flops_total"] > 0,
          "phase 19b: the ranks' FLOPs cover the model's 6 N D")
    check({"all-gather", "reduce-scatter", "all-reduce"}
          <= set(rec["collectives_by_op"]),
          "phase 19b: the parameters' all-gathers, the gradients' "
          "reduce-scatters and the all-reduces counted")
    return rec


def merge_sharded(kernels: list, out: dict) -> None:
    """Count phase 19a's sharded-loop flash launches in the flash rows'
    ``launches``, ``launches_by_variant`` and ``by_path``: the forward's
    and the backward's."""
    for row in kernels:
        if row["name"] == "flash_attention_bwd":
            n = out["sharded"]["launches"]["flash_attention_bwd"]
            row["by_path"] = {
                "Hymba-1.5B train loop (phase 14)": row["launches"],
                "Qwen3-1.7B train loop on DTensor state (phase 19)": n}
            row["launches"] += n
        if row["name"] != "flash_attention":
            continue
        n = out["sharded"]["launches"]["flash_attention"]
        row.setdefault("by_path", {})[
            "Qwen3-1.7B train loop on DTensor state (phase 19)"] = n
        row["launches"] += n
        for kind, k in out["sharded"]["flash_variants"].items():
            row["launches_by_variant"][kind] += k


# ----------------------------------------------------------------------
# phase 20: the remaining dense configs
# ----------------------------------------------------------------------
# 20a: each at full width cut to DENSE_IDENT_LAYERS layers, fp32, card
# against CPU: make_prefill_step on DENSE_IDENT_BATCH x DENSE_IDENT_TOKENS,
# then make_serve_step teacher-forcing DENSE_IDENT_PROMPT tokens and
# generating DENSE_IDENT_NEW (8 steps in all); then Granite's cut model
# through ServingEngine on DENSE_ENGINE_REQUESTS prompts of 40-100 tokens
# under a device pool of three zones of 32 positions, so a sequence is
# demoted and decodes from the host tier
DENSE_IDENTITY = ["qwen2.5-14b", "minitron-4b", "granite-34b"]
DENSE_IDENT_LAYERS = 2
DENSE_IDENT_BATCH, DENSE_IDENT_TOKENS = 2, 64
DENSE_IDENT_PROMPT, DENSE_IDENT_NEW = 4, 5
DENSE_ENGINE = "granite-34b"
DENSE_ENGINE_REQUESTS, DENSE_ENGINE_NEW = 2, 8
DENSE_ENGINE_POOLS = dict(page_size=16, pages_per_zone=2, hbm_zones=3,
                          host_zones=32, cache_zones=1, max_batch=2)
DENSE_TOL = 1e-4
# 20b: (model, layers or None for all, prompts, tokens) through
# phase_family_main, its decode DENSE_PROMPT forced and DENSE_NEW generated
# tokens from the prefill's context (15 steps: phase 16's 63 at these
# widths are 5-9 s a model of host-bound steps); Granite-34B (1.06 GB a
# layer in bf16, 94.5 GB whole) cut to the layers that leave MIN_FREE_GIB
# free of the 80 GB card
GRANITE_LAYERS = 64
DENSE_PROMPT, DENSE_NEW = 8, 8
DENSE_MAIN = [("qwen2.5-14b", None, 4, 2048), ("minitron-4b", None, 4, 2048),
              ("granite-34b", GRANITE_LAYERS, 4, 2048)]
# then Granite's cut model, the same weights, through ServingEngine: four
# requests of 512-1,536 prompt tokens, 16 new tokens each, on a device pool
# that holds them all
DENSE_SERVE_REQUESTS, DENSE_SERVE_NEW = 4, 16
DENSE_SERVE_POOLS = dict(page_size=16, pages_per_zone=8, hbm_zones=64,
                         host_zones=16, cache_zones=2, max_batch=4)


def dense_identity_run(cfg, model, long: np.ndarray, short: np.ndarray,
                       dev) -> dict:
    """``make_prefill_step`` on ``long`` and ``make_serve_step`` over
    ``short`` (fp32 caches) on ``dev``, the counts zeroed before and read
    after; the flash windows recorded."""
    reset_model_launches()
    with ModelRecorder() as rec:
        t0 = time.perf_counter()
        nxt = make_prefill_step(cfg)(
            model, {"tokens": torch.from_numpy(long).to(dev)})
        _, gen, logs, nonfinite, steps = serve(
            cfg, model, short, DENSE_IDENT_NEW, dev, keep_logits=True,
            cache_dtype=torch.float32)
        sync(dev)
        wall = time.perf_counter() - t0
    return {"prefill": nxt.float().cpu(), "decode": logs, "gen": gen.cpu(),
            "steps": steps, "nonfinite": int(nonfinite) + int(
                (~torch.isfinite(nxt)).sum()),
            "windows": rec.windows, "launches": model_launches(),
            "wall_s": wall}


def phase_dense_identity(card_dev: str = "cuda") -> dict:
    """Phase 20a: the three dense configs at full width cut to two layers,
    fp32 weights made on the card from one seeded generator and copied to
    the CPU, TF32 off, card against CPU."""
    out = {}
    for name in DENSE_IDENTITY:
        cfg = dataclasses.replace(get_config(name),
                                  num_layers=DENSE_IDENT_LAYERS)
        model = init_model(cfg, seed=0, device=card_dev, dtype=torch.float32)
        models = {card_dev: model, "cpu": copy.deepcopy(model).to("cpu")}
        rng = np.random.default_rng(20)
        long = rng.integers(0, cfg.vocab_size, (
            DENSE_IDENT_BATCH, DENSE_IDENT_TOKENS)).astype(np.int32)
        short = rng.integers(0, cfg.vocab_size, (
            DENSE_IDENT_BATCH, DENSE_IDENT_PROMPT)).astype(np.int32)
        runs = {dev: dense_identity_run(cfg, m, long, short, dev)
                for dev, m in models.items()}
        card, cpu = runs[card_dev], runs["cpu"]
        n = cfg.num_layers
        r = {"layers": n, "heads": [cfg.num_heads, cfg.num_kv_heads],
             "d_model": cfg.d_model, "vocab": cfg.vocab_size,
             "prefill_tokens": list(long.shape),
             "serve": [DENSE_IDENT_BATCH, DENSE_IDENT_PROMPT,
                       DENSE_IDENT_NEW], "decode_steps": card["steps"],
             "prefill_rel_err": rel_err(card["prefill"], cpu["prefill"]),
             "decode_rel_err": max(rel_err(g, c) for g, c in
                                   zip(card["decode"], cpu["decode"])),
             "tokens_identical": bool(torch.equal(card["gen"], cpu["gen"])),
             "launches": {d: x["launches"] for d, x in runs.items()},
             "wall_s": {d: x["wall_s"] for d, x in runs.items()}}
        tag = f"phase 20a {name}"
        if name == DENSE_ENGINE:
            rng = np.random.default_rng(20)
            prompts = [rng.integers(0, cfg.vocab_size, k).astype(np.int32)
                       for k in rng.integers(40, 101, DENSE_ENGINE_REQUESTS)]
            r["engine"] = engine_identity(cfg, models, prompts,
                                          DENSE_ENGINE_NEW,
                                          **DENSE_ENGINE_POOLS)[0]
        out[name] = r
        del models, model
        torch.cuda.empty_cache()
        check(r["prefill_rel_err"] <= DENSE_TOL,
              f"{tag}: card prefill logits within 1e-4 of the CPU's")
        check(r["decode_rel_err"] <= DENSE_TOL,
              f"{tag}: card decode logits within 1e-4 of the CPU's")
        check(r["tokens_identical"], f"{tag}: greedy tokens identical")
        check(len(card["decode"]) == len(cpu["decode"]) == card["steps"]
              == DENSE_IDENT_PROMPT + DENSE_IDENT_NEW - 1,
              f"{tag}: one logits vector a decode step")
        check(card["nonfinite"] == cpu["nonfinite"] == 0,
              f"{tag}: finite logits")
        check(card["launches"]["flash_attention"] == n
              and sum(card["launches"].values()) == n
              and card["windows"] == [None] * n,
              f"{tag}: one flash launch (full attention) per layer of the "
              "prefill on the card, nothing else")
        check(not any(cpu["launches"].values()),
              f"{tag}: the CPU run launched no kernel")
        if name != DENSE_ENGINE:
            continue
        e = r["engine"]
        forwards = DENSE_ENGINE_REQUESTS * DENSE_ENGINE_NEW
        check(e["tokens_identical"] and e["stats_identical"]
              and e["pool_bytes_identical"],
              f"{tag} engine: card and CPU tokens, stats and pool byte "
              "counters identical")
        check(e["steps_compared"] == forwards and e["max_rel_logit_err"]
              <= DENSE_TOL,
              f"{tag} engine: every forward's logits within 1e-4 of the "
              "CPU's")
        check(e["stats"]["demotions"] + e["stats"]["host_placements"] > 0
              and e["staged_bytes"]["cpu"] == e["staged_bytes"][card_dev]
              > 0, f"{tag} engine: a sequence placed on or demoted to the "
              "host tier and decoded from there")
        check(e["launches"][card_dev] == {
                  "paged_attention": n * (forwards - DENSE_ENGINE_REQUESTS),
                  "flash_attention": n * DENSE_ENGINE_REQUESTS,
                  "flash_attention_bwd": 0}
              and e["paged_groups"] == [cfg.num_heads // cfg.num_kv_heads],
              f"{tag} engine: one paged launch per layer of each decode "
              "step, all at G 48, one flash per layer of each prefill, no "
              "backward")
        check(not any(e["launches"]["cpu"].values()),
              f"{tag} engine: the CPU run launched no kernel")
    return out


def dense_engine_main(cfg, model, dev: str = "cuda") -> dict:
    """Phase 20b's engine: ``model`` (Granite's cut model, on the card)
    through ``serve_requests`` on DENSE_SERVE_REQUESTS requests, the first
    paged call kept.  Returns the record and (as "call") the kept call."""
    out, rec = serve_requests(cfg, model, dev, DENSE_SERVE_REQUESTS,
                              DENSE_SERVE_NEW, {"flash_attention": set(),
                                                "paged_attention": {0}},
                              **DENSE_SERVE_POOLS)
    emit(phase20b_engine=out)           # before its checks
    tag = "phase 20b granite-34b engine"
    check_served(out, tag)
    check(out["paged_groups"] == [cfg.num_heads // cfg.num_kv_heads],
          f"{tag}: every paged launch at G 48")
    out["call"] = rec.calls["paged_attention"][0]
    torch.cuda.empty_cache()
    return out


def paged_entry(call, launches: int) -> dict:
    """One paged call (q, pages, block table, lens) through the kernel and
    its plain version (fp32 2e-5), timed with CUDA events (``ms``, back to
    back through the wrapper; ``bracketed_ms``, events around single
    launches) and the profiler (``device_ms``, the kernel alone; None
    when the profiler records no launch of it) beside its bound, the
    plain version and scaled_dot_product_attention over the gathered
    pages."""
    q, kp = call[0], call[1]
    err, ok = within(paged_kernel.paged_attention_decode(*call),
                     paged_attention_ref(*call), TOL[q.dtype])
    check(ok, f"phase 20b paged G {q.shape[1] // kp.shape[2]}: within "
          f"{TOL[q.dtype]} of plain on the captured call")
    gqa = sdpa_gqa()
    lib_fn, lib_args = library_call("paged_attention", call, gqa)
    t_bytes, t_ops = attention_bound("paged_attention", call)
    h, kvh = q.shape[1], kp.shape[2]
    return {"group": h // kvh, "heads": [h, kvh], "head_dim": q.shape[2],
            "chunks": paged_kernel.group_chunks(h, kvh),
            "context": int(call[4][0]) + 1,
            "splits": paged_kernel.split_plan(call[3].shape[1],
                                              kp.shape[1])[1],
            "dtype": str(q.dtype).split(".")[1], "launches": launches,
            "max_abs_err": err,
            "ms": cuda_ms(paged_kernel.paged_attention_decode, [call], 50),
            "device_ms": device_ms(paged_kernel.paged_attention_decode,
                                   [call] * 20, "paged_decode_kernel"),
            "bracketed_ms": bracketed_ms(
                paged_kernel.paged_attention_decode, [call], 20),
            "plain_ms": cuda_ms(paged_attention_ref, [call], 10),
            "library_ms": cuda_ms(lib_fn, [lib_args], 50),
            "library": "scaled_dot_product_attention" + (
                "(enable_gqa)" if gqa else " (K/V repeated to H heads)"),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_bytes_ms": 1e3 * t_bytes, "bound_ops_ms": 1e3 * t_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def merge_dense_engine(kernels: list, engine: dict, entry: dict) -> None:
    """Count phase 20b's engine launches in the paged and flash rows'
    ``launches`` and ``by_path`` (the flash row's variants too), and give
    the paged row the G 48 call's timings in ``by_model``.  No-op without
    phase 8's rows."""
    path = "Granite-34B serving (phase 20)"
    for row in kernels:
        name = row["name"]
        if name not in ("paged_attention", "flash_attention"):
            continue
        n = engine["launches"][name]
        if name == "paged_attention":
            row.setdefault("by_path", {
                "Qwen3-1.7B serving (phase 7)": row["launches"]})
            row.setdefault("by_model", {})[
                "granite-34b engine decode G 48"] = entry
        else:
            for kind, k in engine["flash_variants"].items():
                row["launches_by_variant"][kind] += k
        row["by_path"][path] = n
        row["launches"] += n


# ----------------------------------------------------------------------
# phase 21: the repo's four examples through the port's twins
# ----------------------------------------------------------------------
EXAMPLE_REFERENCE = ROOT / "tests" / "data" / "examples_reference"


# (twin, its arguments, the file of the reference example's lines it is
# held against (serve_paged: a CPU run of the twin), the kernels it must
# launch); ycsb_demo at --quick and train_lm at its default size, for the
# script's time limit (at their full sizes they take ~66 s and ~82 s on an
# H100)
EXAMPLE_RUNS = [
    ("quickstart", [], "quickstart.txt", ("bloom_probe_pairs",)),
    ("ycsb_demo", ["--quick"], "ycsb_demo_quick.txt",
     ("bloom_probe_pairs",)),
    ("serve_paged", [], None, ("flash_attention", "paged_attention")),
    ("train_lm", [], "train_lm.txt",
     ("flash_attention", "flash_attention_bwd")),
]
# the wrappers whose first call (of each window) in a twin is kept and
# held against its plain version
FIRST_CALLS = {
    "flash_attention_fwd": (flash_kernel, "flash_attention_fwd"),
    "flash_attention_bwd": (flash_kernel, "flash_attention_bwd"),
    "paged_attention_decode": (paged_kernel, "paged_attention_decode")}


def load_example(name: str):
    """``examples/<name>.py`` as a fresh module (a twin: ``<name>`` ends
    in ``_torch``)."""
    spec = importlib.util.spec_from_file_location(
        f"examples_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def wall_free(lines: list) -> list:
    """serve_paged's printed lines without the wall-clock tokens a
    second."""
    return [line.split(" (")[0] if "tok/s wall" in line else line
            for line in lines]


def check_twin(name: str, out, expected) -> dict:
    """Hold one twin's card run against the reference example's lines (or,
    for serve_paged, a CPU run of the twin); what was compared."""
    tag = f"phase 21 {name}"
    if name in ("quickstart", "ycsb_demo"):
        check("\n".join(out).splitlines() == expected,
              f"{tag}: the reference example's lines")
        return {"lines_equal_reference": True}
    if name == "serve_paged":
        cpu = load_example(f"{name}_torch").main(["--device", "cpu"])
        same = sum(out["tokens"][rid] == toks
                   for rid, toks in cpu["tokens"].items())
        check(out["stats"] == cpu["stats"]
              and wall_free(out["lines"]) == wall_free(cpu["lines"]),
              f"{tag}: counters those of the CPU run")
        check(same == len(cpu["tokens"]) == len(out["tokens"]),
              f"{tag}: every request's tokens those of the CPU run")
        return {"counters_equal_cpu": True, "cpu_seconds": cpu["wall_s"],
                "requests_with_cpu_tokens": same,
                "requests": len(cpu["tokens"])}
    lines = [line for line in out["lines"] if not line.startswith("[train]")]
    check(lines[:2] == expected, f"{tag}: the reference example's model and "
          "restarts lines")
    check(out["losses"][-1][1] < out["losses"][0][1], f"{tag}: loss falls")
    return {"model_and_restarts_equal_reference": True,
            "losses": out["losses"]}


@torch.no_grad()
def hold_first_calls(calls: dict, tag: str) -> tuple:
    """Each kept call through its kernel against its plain version:
    attention within TOL, the backward within FLASH_BWD_TOL of each
    gradient's largest (of the plain backward and of autograd) and bit for
    bit from one launch to the next.  Returns (a record, the checks as
    (condition, what) pairs)."""
    out, checks = {}, []
    for (q, k, v), kw in calls["flash_attention_fwd"].values():
        causal, window = kw.get("causal", True), kw.get("window")
        err, ok = within(flash_kernel.flash_attention_fwd(
            q, k, v, causal=causal, window=window),
            attention_plain(q, k, v, causal, window), TOL[q.dtype])
        out[f"flash_attention_window{window}"] = {
            "q": list(q.shape), "kv_heads": k.shape[1],
            "dtype": str(q.dtype).split(".")[1], "causal": causal,
            "variant": flash_kernel.variant(q.dtype, q.shape[3]),
            "max_abs_err": err}
        checks.append((ok, f"{tag}: the first flash call (window {window}) "
                       f"within {TOL[q.dtype]} of plain"))
    for args, kw in calls["flash_attention_bwd"].values():
        window = kw.get("window")
        r = flash_bwd_held(*args, kw.get("causal", True), window)
        out[f"flash_attention_bwd_window{window}"] = {
            "q": list(args[0].shape), **r}
        checks.append((r["ok"] and r["bitwise_repeat"], f"{tag}: the first "
                       f"flash backward (window {window}) within "
                       f"{FLASH_BWD_TOL[args[0].dtype]} of the plain "
                       "backward and of autograd, bit for bit again"))
    for args, _ in calls["paged_attention_decode"].values():
        q, kp = args[0], args[1]
        err, ok = within(paged_kernel.paged_attention_decode(*args),
                         paged_attention_ref(*args), TOL[q.dtype])
        out["paged_attention"] = {
            "q": list(q.shape), "pages": list(kp.shape),
            "tables": list(args[3].shape),
            "dtype": str(q.dtype).split(".")[1],
            "splits": paged_kernel.split_plan(args[3].shape[1], kp.shape[1]),
            "max_abs_err": err}
        checks.append((ok, f"{tag}: the first paged call within "
                       f"{TOL[q.dtype]} of plain"))
    return out, checks


def phase_examples(dev: str = "cuda", runs: list = EXAMPLE_RUNS) -> dict:
    """Phase 21: each twin's ``main`` on the card, the launch counts zeroed
    just before it and read just after; its lines held against the
    reference's; every kernel of its path launched, the first call of
    each held against its plain version, and in train_lm every flash call
    (forward and backward) on the tensor cores."""
    out = {}
    for name, argv, file, kernels in runs:
        expected = (None if file is None else
                    (EXAMPLE_REFERENCE / file).read_text().splitlines())
        twin = load_example(f"{name}_torch")
        reset_model_launches()
        t0 = time.perf_counter()
        with FirstCalls(FIRST_CALLS) as first:
            got = twin.main(argv + ["--device", dev])
        sync(dev)
        seconds = time.perf_counter() - t0
        launched = {k: v for k, v in model_launches().items() if v}
        rec = {"argv": argv, "seconds": seconds, "launches": launched,
               "flash_variants": dict(flash_kernel.variant_launches),
               "flash_bwd_variants": dict(flash_kernel.bwd_variant_launches)}
        emit(phase21={name: rec})           # before its checks
        tag = f"phase 21 {name}"
        for k in kernels:
            check(launched.get(k, 0) > 0, f"{tag}: {k} launched")
        if name == "train_lm":
            check(rec["flash_variants"]["mma"]
                  == launched.get("flash_attention", 0)
                  and rec["flash_bwd_variants"]["mma"]
                  == launched.get("flash_attention_bwd", 0),
                  f"{tag}: every flash call on the tensor cores")
        kept, checks = hold_first_calls(first.calls, tag)
        del first
        emit(phase21_first_calls={name: kept})  # before its checks
        for cond, what in checks:
            check(cond, what)
        held = {"first_calls": kept, **check_twin(name, got, expected)}
        emit(phase21_held={name: held})
        rec.update(held)
        out[name] = rec
    torch.cuda.empty_cache()
    return out


def merge_examples(kernels: list, out: dict) -> None:
    """Count phase 21's launches in the rows of the kernels the twins
    launch: ``launches``, ``by_path`` and flash's variants."""
    for row in kernels:
        name = row["name"]
        for twin, rec in out.items():
            n = rec["launches"].get(name, 0)
            if not n:
                continue
            row.setdefault("by_path", {})[
                f"examples/{twin}_torch.py (phase 21)"] = n
            row["launches"] += n
            if name == "flash_attention":
                for kind, k in rec["flash_variants"].items():
                    row["launches_by_variant"][kind] += k


def timings(card: str, kernels: list) -> dict:
    return {"card": card, "kernels": [
        {k: v for k, v in d.items() if k in (
            "name", "ms", "plain_ms", "device_ms", "floor_ms",
            "one_item_ms", "round_trip_ms", "checked_ms", "bound_ms",
            "bound_sfu_ms", "library_ms",
            "timed_calls", "mean_items_per_call", "mean_context",
            "mean_prompt", "by_model")}
        for d in kernels]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(map(str, ALL_PHASES)),
                    help="comma-separated phases to run (4 needs 3, 8 "
                         "needs 7, 12 needs 11); the result lines print "
                         "only when all twenty-one run")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}
    for later, first in ((4, 3), (8, 7), (12, 11)):
        if later in phases and first not in phases:
            ap.error(f"phase {later} needs phase {first}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    # phases 1-4 launch the Bloom probe alone: the other kernels compile
    # while they run
    rest = (paged_kernel, flash_kernel, scan_kernel)
    started = _build.start_all([mod.SOURCE for mod in rest], force=True)
    try:
        libs = _build.build_all([kernel.SOURCE], force=True)
        kernel.load()
    except BaseException:
        _build.stop_all(started)
        raise
    emit(build={"libraries": [str(lib.relative_to(ROOT)) for lib in libs],
                "seconds": time.perf_counter() - t0})
    dev = torch.device("cuda")
    kernels = []
    last = [time.perf_counter()]

    def seconds() -> float:
        """Seconds since the last call (the first: since the build)."""
        now = time.perf_counter()
        out, last[0] = now - last[0], now
        return out
    try:
        if 1 in phases:
            emit(phase1=phase_kernels(dev), card=card, seconds=seconds())
        paper_keys = ScenarioConfig().paper_keys
        if 2 in phases:
            emit(phase2=phase_identity(paper_keys // 16), card=card,
                 seconds=seconds())
        if 3 in phases:
            main_out, row, rec, pk_rec = phase_main(paper_keys)
            emit(phase3=main_out, card=card, seconds=seconds())
            emit(phase3_row=row)
        if 4 in phases:
            kernels += phase_captured(rec, pk_rec,
                                      main_out["main_path"]["launches"],
                                      main_out["perkey_path"]["launches"],
                                      paper_keys)
            emit(phase4=timings(card, kernels), seconds=seconds())
    except BaseException:
        _build.stop_all(started)
        raise
    libs = _build.finish_all(started)
    for mod in rest:
        mod.load()
    emit(build={"libraries": [str(lib.relative_to(ROOT)) for lib in libs],
                "seconds": time.perf_counter() - t0}, seconds=seconds())
    if 5 in phases:
        emit(phase5=phase_attention_kernels(dev), card=card,
             seconds=seconds())
    if 6 in phases:
        emit(phase6=phase_serving_identity(), card=card, seconds=seconds())
    if 7 in phases:
        serve_out, serve_rec = phase_serving_main(
            n_requests=SERVE_RUN_REQUESTS)
        emit(phase7=serve_out, card=card, seconds=seconds())
    if 8 in phases:
        attention = phase_attention_captured(serve_rec,
                                             serve_out["launches"],
                                             serve_out["flash_variants"])
        emit(phase8=timings(card, attention), seconds=seconds())
        kernels += attention
    if 9 in phases:
        emit(phase9=phase_scan_kernels(dev), card=card, seconds=seconds())
    if 10 in phases:
        emit(phase10=phase_model_identity(), card=card, seconds=seconds())
    if 11 in phases:
        model_out, captured, flashes = {}, {}, {}
        for name in MODEL_MAIN:
            model_out[name], captured[name], flashes[name] = \
                phase_model_main(name)
            emit(phase11={name: model_out[name]}, card=card)
        emit(phase11_seconds=seconds())
    if 12 in phases:
        launched = {k: sum(o["prefill"]["launches"][k]
                           for o in model_out.values())
                    for k in ("selective_scan", "selective_scan_fused")}
        scans = phase_scan_captured(captured, launched)
        flash_by_model = phase_flash_captured(
            flashes, {m: o["prefill"]["launches"]["flash_attention"]
                      for m, o in model_out.items()})
        emit(phase12=timings(card, scans), phase12_flash=flash_by_model,
             seconds=seconds())
        kernels += scans
        merge_flash(kernels, flash_by_model,
                    {m: o["prefill"]["flash_variants"]
                     for m, o in model_out.items()})
    if 11 in phases:
        emit(phase11_busy=phase_busy_share(model_out), card=card,
             seconds=seconds())
        del captured, flashes
        torch.cuda.empty_cache()
    if 13 in phases:
        train_ident = phase_train_identity()
        emit(phase13={k: train_ident[k] for k in ("kill_and_resume",
                                                    "checkpoint")},
             seconds=seconds(), card=card)
    if 14 in phases:
        train_main = phase_train_main()
        emit(phase14=train_main, seconds=seconds(), card=card)
        merge_training(kernels, {k: train_main["launches"][k] for k in
                                 ("flash_attention", "selective_scan_fused")},
                       train_main["flash_variants"])
        kernels += train_main["backward_kernels"]
    if 15 in phases:
        phase_family_identity()
        emit(phase15_seconds=seconds(), card=card)
    family_out = {}
    if 16 in phases:
        family_calls = {}
        for spec in FAMILY_MAIN:
            family_out[spec[0]], family_calls[spec[0]] = \
                phase_family_main(*spec)
        by_shape = phase_flash_families(family_calls, family_out)
        del family_calls
        torch.cuda.empty_cache()
        emit(phase16_flash=by_shape, seconds=seconds(), card=card)
        merge_families(kernels, by_shape, family_out)
    if 17 in phases:
        ident = phase_control_identity(paper_keys)
        emit(phase17a=ident, card=card, seconds=seconds())
        cells = phase_control_main(paper_keys)
        emit(phase17b=cells, card=card, seconds=seconds())
        merge_store_paths(kernels, {
            "17a matrix on the card (phase 17)": ident["launches"]["card"],
            "17a matrix, telemetry off (phase 17)":
                ident["launches"]["card_telemetry_off"],
            "bench_control pi+knobs (phase 17)":
                cells["control"]["launches"],
            "bench_sharding skew, rebalanced (phase 17)":
                cells["sharding"]["launches"]})
    if 18 in phases:
        init_group()
        try:
            phase_mesh_identity()
            emit(phase18a_seconds=seconds(), card=card)
            mesh_main = phase_mesh_main(
                unsharded=family_out.get("olmoe-1b-7b"))
            emit(phase18b_seconds=seconds(), card=card)
        finally:
            dist.destroy_process_group()
        merge_mesh(kernels, mesh_main)
    if 19 in phases:
        sharded = phase_sharded_train()
        emit(phase19a_seconds=seconds(), card=card)
        phase_dryrun_cell()
        emit(phase19b_seconds=seconds(), card=card)
        merge_sharded(kernels, sharded)
    if 20 in phases:
        emit(phase20a=phase_dense_identity(), card=card, seconds=seconds())
        dense_out, dense_calls, engine = {}, {}, {}
        for name, layers, b, t in DENSE_MAIN:
            dense_out[name], dense_calls[name] = phase_family_main(
                name, layers, b, t, phase="20b", prompt=DENSE_PROMPT,
                new=DENSE_NEW,
                then=(lambda cfg, model: engine.update(
                    dense_engine_main(cfg, model)))
                if name == DENSE_ENGINE else None)
        by_shape = phase_flash_families(dense_calls, dense_out, "20b")
        del dense_calls
        entry = paged_entry(engine.pop("call"),
                            engine["launches"]["paged_attention"])
        torch.cuda.empty_cache()
        emit(phase20b_flash=by_shape, phase20b_paged=entry,
             seconds=seconds(), card=card)
        merge_families(kernels, by_shape, dense_out,
                       "dense configs' prefill (phase 20)")
        merge_dense_engine(kernels, engine, entry)
    if 21 in phases:
        examples = phase_examples()
        emit(phase21_seconds=seconds(), card=card)
        merge_examples(kernels, examples)
    if phases != set(ALL_PHASES):
        return 0
    emit(kernels=kernels)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
