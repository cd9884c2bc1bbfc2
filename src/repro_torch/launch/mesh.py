"""Device meshes over ``torch.distributed`` (the port of
``repro.launch.mesh``).

Functions, not module-level constants: importing this module starts no
process group.  The clustering funnel needs a 1-D mesh with one named
axis (DESIGN.md §4.4); ``dist.sharding.data_mesh`` builds it, and the
training driver a ``("data", "model")`` mesh, each starting a process
group of world size 1 when the caller has none.  A process started with
the ``env://`` rendezvous variables (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``: ``torchrun``, or ``launch/cluster.py``'s
worker) joins that group instead.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def ensure_process_group(device=None) -> int:
    """The default process group's world size, after starting one when
    none exists: from the ``env://`` variables where they are set
    (``LOCAL_RANK`` picks the card), else of world size 1 from an
    in-memory store; NCCL for a CUDA ``device`` (the default), gloo for
    the CPU.  A group the caller started is used as it is."""
    if dist.is_initialized():
        return dist.get_world_size()
    dev = torch.device("cuda" if device is None else device)
    env = all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT",
                                        "WORLD_SIZE", "RANK"))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA mesh needs a card and none is available; pass "
                "device='cpu' for a gloo group")
        if env:
            idx = int(os.environ.get("LOCAL_RANK", 0))
            torch.cuda.set_device(idx)
            dist.init_process_group("nccl", init_method="env://",
                                    device_id=torch.device("cuda", idx))
            return dist.get_world_size()
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1,
                                device_id=torch.device("cuda", idx))
    elif env:
        dist.init_process_group("gloo", init_method="env://")
        return dist.get_world_size()
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


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """The reference's production mesh over the default process group:
    ("data", "model") (16, 16), 256 ranks, or ("pod", "data", "model")
    (2, 16, 16), 512 ranks.  ``pod`` is pure data parallelism across
    pods, ``data`` data parallelism with FSDP / ZeRO-3 within a pod,
    ``model`` tensor (and expert) parallelism.  Raises ValueError when
    the group (none counts as one rank) has another size, as on one
    card; ``dist.sharding.AbstractMesh`` reads the placement rules at
    these shapes without a group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    return make_mesh(shape, axes, device=device)
