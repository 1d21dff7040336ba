"""A toy copy of the benchmark for CPU tests: the real files under a
temporary root, with a manifest, configurations, mixes and cells of
smoke size beside them."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

HYBRID = {
    "name": "toy-hybrid", "source": "test", "family": "hybrid",
    "dtype": "bfloat16", "num_layers": 2, "d_model": 64, "num_heads": 4,
    "num_kv_heads": 2, "head_dim": 16, "d_ff": 128, "act": "swiglu",
    "vocab_size": 256, "tie_embeddings": False, "sliding_window": 16,
    "full_attn_layers": [0], "rope_theta": 10000.0, "ssm_state": 8,
    "ssm_conv": 4, "d_inner": 128, "dt_rank": 4, "norm_eps": 1e-6,
    "assumed": []}
SSM = dict(HYBRID, name="toy-ssm", family="ssm", num_heads=0,
           num_kv_heads=0, d_ff=0, sliding_window=None, full_attn_layers=[])
MIXES = {
    "train-toy": {"driver": "train", "batch": 2, "seq": 32, "remat": True,
                  "grad_accum": 1, "optimizer": {
                      "learning_rate": 0.0003, "warmup_steps": 100,
                      "total_steps": 1000, "weight_decay": 0.01,
                      "beta1": 0.9, "beta2": 0.95, "grad_clip": 1.0},
                  "checked_steps": 3, "trace_steps": 2},
    "decode-toy": {"driver": "decode", "batch": 4, "prompt": 4,
                   "max_len": 256, "check_rows": 4, "trace_steps": 3},
    "prefill-toy": {"driver": "prefill", "batch": 2, "seq": 32, "warmup": 1,
                    "check_calls": 2, "check_rows": 1, "trace_steps": 2},
}
# limits between the toy's own readings and its control's (CPU, seeds
# 1-4: program at most 0.0042 / 0.0023, control at least 0.027 / 0.011; decode 0.039 / 0.011 / 0.0076 against 0.32 /
# 0.11 / 0.077; prefill 0.016 against 0.107)
CELLS = {
    "toy-hybrid.train-toy": {"checks": {"grad_gap": 0.015,
                                        "change_gap": 0.006}},
    "toy-ssm.decode-toy": {"checks": {"token_gap": 0.15, "ssm_gap": 0.04,
                                      "conv_gap": 0.03}},
    "toy-ssm.prefill-toy": {"checks": {"logit_err": 0.05}},
}
FAULTS = {"toy-hybrid.train-toy": ("unchanged", "half_batch", "token_altered"),
          "toy-ssm.decode-toy": ("unchanged", "half_batch", "token_altered"),
          "toy-ssm.prefill-toy": ("half_batch", "token_altered")}


def make(root: Path) -> Path:
    """The benchmark's files under ``root/port_bench`` and a manifest of
    the toy cells at ``root/BENCHMARK.json``; returns ``root``."""
    bench = root / "port_bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    for cfg in (HYBRID, SSM):
        (bench / "configs" / f"{cfg['name']}.json").write_text(
            json.dumps(cfg))
    for name, mix in MIXES.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for name, cell in CELLS.items():
        (bench / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    manifest["configs"] = [
        {"name": c["name"], "source": "test",
         "file": f"port_bench/configs/{c['name']}.json", "reduced": [],
         "why": "toy"} for c in (HYBRID, SSM)]
    manifest["workloads"] = [
        {"name": n, "config": n.split(".")[0], "traffic": n.split(".")[1],
         "chips": 1, "why": "toy"} for n in CELLS]
    kinds = {"train": "toy-hybrid.train-toy", "decode": "toy-ssm.decode-toy",
             "prefill": "toy-ssm.prefill-toy"}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [kinds[k] for k in kinds
                              if any(k in w for w in m["workloads"])]
    (root / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return root
