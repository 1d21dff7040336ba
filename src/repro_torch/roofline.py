"""Roofline analysis of one traced step on a fake process group (no card).

Three terms per (arch x shape x mesh), in seconds, as the reference's
``roofline.py`` has them:

  compute    = per-device FLOPs / peak FLOP/s              (989 TFLOP/s bf16)
  memory     = per-device bytes / HBM bandwidth            (3.35 TB/s)
  collective = per-device collective bytes / link bandwidth (450 GB/s)

The constants are NVIDIA's datasheet figures for one H100 SXM: dense
bf16 tensor-core throughput, HBM3 bandwidth, and one direction of NVLink
4 (900 GB/s both ways).  They are the card's ceilings, not measurements.

The reference reads its quantities from compiled HLO text
(``analyze_hlo``).  The port has no compiled program: it runs the step
once, under ``FakeTensorMode`` on a fake process group
(``launch/dryrun.py``), and ``StepCounter``, a ``TorchDispatchMode``,
reads the same quantities from the operations the dispatcher sees, each
on the tensors one rank holds (a DTensor's local shard):

  FLOPs       every operation ``torch.utils.flop_counter`` has a formula
              for (matrix products, attention, convolutions), by that
              formula: the reference counts ``dot`` instructions alike;
  bytes       each ATen operation's operand and result bytes, as the
              reference counts a top-level instruction's (views,
              allocations and queries of metadata move nothing and count
              nothing);
  collectives each ``_c10d_functional`` or ``c10d`` collective by kind,
              its ring traffic from the result's bytes and the group's
              size (``_ring_bytes``, the reference's).

Python runs every layer, so nothing is counted once for a loop's many
trips (the reference's multiplier propagation has no counterpart here).
Elementwise operations carry no FLOPs, as XLA's ``dot`` count has none.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# NVIDIA H100 SXM datasheet figures (per card)
PEAK_FLOPS = 989e12          # dense bf16, tensor cores
HBM_BW = 3.35e12             # bytes/s, HBM3
LINK_BW = 450e9              # bytes/s, NVLink 4, one direction

_FUNCTIONAL = {"all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_reduce": "all-reduce",
               "all_to_all_single": "all-to-all"}
# what torch.distributed's all_gather_into_tensor, reduce_scatter_tensor,
# all_reduce and all_to_all_single dispatch
_C10D = {"_allgather_base_": "all-gather",
         "_reduce_scatter_base_": "reduce-scatter",
         "allreduce_": "all-reduce", "alltoall_base_": "all-to-all"}
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "lift_fresh", "alias", "set_",
         "resize_", "_local_scalar_dense"}


def _ring_bytes(op: str, result_bytes: float, s: int) -> float:
    """Per-device ring traffic of one collective over ``s`` ranks whose
    result is ``result_bytes`` (the reference's ``_ring_bytes``)."""
    if s <= 1:
        return 0.0
    frac = (s - 1) / s
    if op == "all-gather":
        return result_bytes * frac
    if op == "all-reduce":
        return 2.0 * result_bytes * frac
    if op == "reduce-scatter":
        return result_bytes * (s - 1)
    if op == "all-to-all":
        return result_bytes * frac
    if op == "collective-permute":
        return result_bytes
    return 0.0


def _local(t):
    """A DTensor's local shard; any other tensor itself."""
    return getattr(t, "_local_tensor", t)


def _nbytes(x) -> float:
    return float(sum(_local(t).numel() * _local(t).element_size()
                     for t in tree_leaves(x) if isinstance(t, torch.Tensor)))


def _group_size(ns: str, name: str, args) -> int:
    """The group size of a functional collective (its ``group_size``, or
    its last argument, the group's name) or a c10d one (its
    ``ProcessGroup`` argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    if ns == "_c10d_functional":
        if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
            return int(args[-2])
        return _resolve_process_group(args[-1]).size()
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch._C.ScriptObject):
            return dist.ProcessGroup.unbox(a).size()
    return 1


@dataclass
class StepStats:
    """What ``StepCounter`` read from one step, per device."""
    flops: float = 0.0
    bytes_hbm: float = 0.0
    collective_bytes: float = 0.0
    coll_by_op: Dict[str, float] = field(default_factory=dict)
    coll_counts: Dict[str, int] = field(default_factory=dict)
    bytes_by_op: Dict[str, float] = field(default_factory=dict)


class StepCounter(TorchDispatchMode):
    """Counts FLOPs, bytes and collectives of every operation dispatched
    inside it (enter it inside ``FakeTensorMode``, so it sees each
    operation before the fake tensors run it).  ``stats`` holds the
    totals."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.stats = StepStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        kind = _FUNCTIONAL.get(name) if ns == "_c10d_functional" \
            else _C10D.get(name) if ns == "c10d" else None
        st = self.stats
        if kind is not None:
            res = out if ns == "_c10d_functional" else args[0]
            b = _ring_bytes(kind, _nbytes(res), _group_size(ns, name, args))
            st.collective_bytes += b
            st.coll_by_op[kind] = st.coll_by_op.get(kind, 0.0) + b
            st.coll_counts[kind] = st.coll_counts.get(kind, 0) + 1
            return out
        if ns in ("_c10d_functional", "c10d"):
            return out
        formula = self.registry.get(func._overloadpacket)
        if formula is not None:
            st.flops += float(formula(*args, **kwargs, out_val=out))
        written = _nbytes(out)
        if ns == "aten" and written and not func.is_view \
                and name not in _FREE:
            b = _nbytes((args, kwargs)) + written
            st.bytes_hbm += b
            st.bytes_by_op[name] = st.bytes_by_op.get(name, 0.0) + b
        return out


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    model_flops_total: float
    memory_per_device: Optional[float] = None   # persistent bytes

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total counted FLOPs (remat & redundancy waste)."""
        total = self.flops_per_device * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs / (chips x peak x bound-time)."""
        denom = self.chips * PEAK_FLOPS * self.bound_s
        return self.model_flops_total / denom if denom else 0.0

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes,
            "model_flops_total": self.model_flops_total,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu": self.mfu,
            "memory_per_device": self.memory_per_device,
        }


def model_flops(cfg, shape) -> float:
    """6·N·D (train) / 2·N·D (prefill/decode), N = active params."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch           # one token per sequence
