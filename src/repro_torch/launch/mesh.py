"""Device meshes over ``torch.distributed`` (the port of
``repro.launch.mesh``'s ``make_mesh``).

A function, not a module-level constant: importing this module starts no
process group.  The clustering funnel needs a 1-D mesh with one named
axis (DESIGN.md §4.4); ``dist.sharding.data_mesh`` builds it, starting a
process group of world size 1 when the caller has none.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def ensure_process_group(device=None) -> int:
    """The default process group's world size, after starting one of world
    size 1 from an in-memory store when none exists: NCCL for a CUDA
    ``device`` (the default), gloo for the CPU.  Under ``torchrun`` the
    caller's group is used as it is."""
    if dist.is_initialized():
        return dist.get_world_size()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA mesh needs a card and none is available; pass "
                "device='cpu' for a gloo group")
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1,
                                device_id=torch.device("cuda", idx))
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return 1


def make_mesh(shape, axes, device=None) -> DeviceMesh:
    """A mesh of ``shape`` with axis names ``axes`` over every rank of the
    default process group (started as :func:`ensure_process_group` does
    when missing), on ``device``'s type (default CUDA)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    world = ensure_process_group(device)
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks; the "
                         f"process group has {world}")
    dev = torch.device("cuda" if device is None else device)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)
