"""Device meshes over the initialized default process group, as the
reference's ``launch/mesh.py`` names them.

Single pod: 16 x 16 = 256 ranks, axes ("data", "model").  Multi-pod: 2 x
256 = 512 ranks with a leading "pod" axis for cross-pod data parallelism
(parameters shard within a pod only).  ``make_local_mesh`` lays out
whatever ranks the group has.  Nothing here starts a process group or
stands in for one: the caller runs ``torch.distributed.init_process_group``
first (``tcp://localhost:<port>`` or a store, its world size and rank),
and a mesh that the group cannot hold raises.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _world_size() -> int:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group before building a mesh")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The reference's production mesh over a group of 256 ranks (512
    with ``multi_pod``)."""
    shape, names = PRODUCTION[multi_pod]
    world = _world_size()
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks; the group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_local_mesh(model_parallel: int = 1,
                    device_type: str = "cuda") -> DeviceMesh:
    """(world // model_parallel, model_parallel) ranks as ("data",
    "model")."""
    world = _world_size()
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"the group's {world} ranks")
    return init_device_mesh(device_type, (world // model_parallel,
                                          model_parallel),
                            mesh_dim_names=("data", "model"))
