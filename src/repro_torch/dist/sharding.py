"""Mesh-aware placement for the clustering pipeline (DESIGN.md §4.4).

The port of the clustering half of ``repro.dist.sharding``: the canonical
layouts of the paper's arrays and the sharded entry points of its three
dense kernels, over ``torch.distributed``.

The reference runs one controller over global arrays; the port runs
SPMD: every rank calls an entry point with the same full input (or a
``DTensor`` already laid out as the entry point wants), works on its own
block with explicit collectives, and returns its block as a ``DTensor``
whose ``full_tensor()`` is the reference's global array.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with a named axis
(:func:`data_mesh`).  Blocks follow ``DTensor``'s own split: rank r of d
holds ceil(n / d) rows (or columns) from r * ceil(n / d) on, the last
ranks fewer.

  * X (n, L) time series   -- rows sharded        (:func:`timeseries_spec`)
  * S (n, n) similarity    -- columns sharded     (:func:`similarity_spec`)
  * batches (B, ...)       -- the batch sharded   (:func:`batch_matrix_spec`)

:func:`pearson_shardmap` standardizes the local rows, all-gathers them
(the one collective) and takes ``clip(Z_full @ Z_local.T, -1, 1)``, S's
local columns, as a plain fp32 product, as the reference does outside
any Pallas kernel.  :func:`topk_pearson_sharded` gathers the rows of X
and runs the top-K kernel on the rank's row range (``ops.topk(...,
row_range=)``), so the table is bitwise the single-device one.
:func:`masked_argmax_shardmap` and :func:`minplus_shardmap` run
``ops.masked_argmax`` and ``ops.minplus`` (the CUDA kernels on the
card) on the local rows, with no collective.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from repro_torch.kernels import ops
from repro_torch.kernels.ref import standardize_rows


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------

def data_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The pure-data-parallel axes present in ``mesh`` (pod before data)."""
    names = mesh.mesh_dim_names or ()
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh: DeviceMesh, axes) -> int:
    """Total extent of one axis name or a tuple of axis names."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in axes)


def data_mesh(n_devices: Optional[int] = None, axis: str = "data", *,
              device=None) -> DeviceMesh:
    """1-D mesh over the ranks of the default process group, for the
    funnel and data-parallel batches.

    Under ``torchrun`` the caller's group is used; with no group, one of
    world size 1 is started from an in-memory store (NCCL for a CUDA
    ``device``, the default; gloo for ``device="cpu"``), the port's
    counterpart of JAX's default of all local devices.  ``n_devices``, if
    given, must be the group's size."""
    from repro_torch.launch.mesh import ensure_process_group, make_mesh

    world = ensure_process_group(device)
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"data_mesh over {n} ranks: the process group has "
                         f"{world} (start it with that many, e.g. torchrun "
                         f"--nproc-per-node {n})")
    return make_mesh((n,), (axis,), device=device)


def check_mesh(mesh, dev: torch.device, axis: str = "data") -> None:
    """Raise unless ``mesh`` is a DeviceMesh on ``dev``'s device type
    with an ``axis`` dimension."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(dist.sharding.data_mesh), got "
                        f"{type(mesh).__name__}")
    if mesh.device_type != dev.type:
        raise ValueError(f"mesh on {mesh.device_type!r}, run on "
                         f"{dev.type!r}")
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh {mesh.mesh_dim_names} has no {axis!r} "
                         f"axis")


def group(mesh: DeviceMesh, axis: str = "data"):
    """The process group of ``axis``."""
    return mesh.get_group(axis)


def rank_of(mesh: DeviceMesh, axis: str = "data") -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def block(n: int, d: int, r: int) -> Tuple[int, int]:
    """(start, size) of rank r's block of n rows over d ranks: ceil(n / d)
    rows from r * ceil(n / d), fewer (or none) at the end, as DTensor
    splits a ``Shard`` placement."""
    size = -(-n // d)
    start = min(r * size, n)
    return start, min(size, n - start)


def my_block(n: int, mesh: DeviceMesh, axis: str = "data"):
    return block(n, axis_size(mesh, axis), rank_of(mesh, axis))


# ---------------------------------------------------------------------------
# clustering-pipeline layouts (the paper's arrays)
# ---------------------------------------------------------------------------

def timeseries_spec(axis="data") -> Placement:
    """X (n, L): rows (series) sharded, time replicated."""
    return Shard(0)


def similarity_spec(axis="data") -> Placement:
    """S (n, n): column-sharded -- every row scan becomes a local scan over
    n/d columns plus one small (value, index) all-gather (DESIGN.md
    §4.4)."""
    return Shard(1)


def batch_matrix_spec(axis="data") -> Placement:
    """A batch (B, n, n) of similarity matrices: the batch axis sharded;
    each matrix lives whole on one rank."""
    return Shard(0)


def batch_timeseries_spec(axis="data") -> Placement:
    """A batch (B, n, L) of datasets, batch-sharded."""
    return Shard(0)


def placements(mesh: DeviceMesh, axis: str,
               p: Placement) -> List[Placement]:
    """``p`` on ``axis``, replicated along every other axis of ``mesh``."""
    return [p if name == axis else Replicate()
            for name in mesh.mesh_dim_names]


def local_block(x, mesh: DeviceMesh, axis: str = "data",
                dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of x: a DTensor's local shard when
    it is sharded so, else the slice of the full tensor."""
    if isinstance(x, DTensor):
        mine = x.placements[mesh.mesh_dim_names.index(axis)]
        if mine == Shard(dim):
            return x.to_local()
        x = x.full_tensor()
    x = torch.as_tensor(x)
    start, size = my_block(x.shape[dim], mesh, axis)
    return x.narrow(dim, start, size)


def as_dtensor(local: torch.Tensor, mesh: DeviceMesh, axis: str,
               spec: Placement, shape) -> DTensor:
    """The DTensor of global ``shape`` laid out by ``spec`` along ``axis``
    whose block on this rank is ``local``."""
    shape = tuple(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements(mesh, axis, spec),
                              run_check=False, shape=shape, stride=stride)


def all_gather_flat(out: torch.Tensor, inp: torch.Tensor, grp) -> None:
    """All-gather ``inp`` from every rank of ``grp`` into ``out``, the
    ranks' tensors one after another along dim 0.  torch 2.13 adds
    ``all_gather_single`` and deprecates ``all_gather_into_tensor``, with
    a warning on every call; older releases have only the latter."""
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, inp, group=grp)


def gather_rows(local: torch.Tensor, n: int, mesh: DeviceMesh,
                axis: str = "data") -> torch.Tensor:
    """The (n, ...) tensor whose row blocks the ranks hold (``local`` this
    rank's): one all-gather of the blocks padded to ceil(n / d) rows."""
    d = axis_size(mesh, axis)
    size = -(-n // d)
    if local.shape[0] < size:
        pad = local.new_zeros((size - local.shape[0],) + local.shape[1:])
        local = torch.cat([local, pad])
    out = local.new_empty((d * size,) + local.shape[1:])
    all_gather_flat(out, local.contiguous(), group(mesh, axis))
    return out[:n]


# ---------------------------------------------------------------------------
# shard-aware kernel wrappers
# ---------------------------------------------------------------------------

def pearson_shardmap(X, mesh: DeviceMesh, axis: str = "data") -> DTensor:
    """Pearson similarity with X row-sharded; S returned column-sharded.

    Each rank standardizes its rows (``ref.standardize_rows``), all-gathers
    the standardized block (the only collective) and runs the local
    (n, L) x (L, n/d) product in fp32 (TF32 is off): the cross-block
    product has no fusable normalization left, so no kernel and no
    ``backend`` here, as in the reference."""
    n = X.shape[0]
    z = standardize_rows(local_block(X, mesh, axis).float())
    zf = gather_rows(z, n, mesh, axis)
    return as_dtensor(torch.clamp(zf @ z.T, -1.0, 1.0), mesh, axis,
                      similarity_spec(axis), (n, n))


def topk_pearson_sharded(X, k: int, mesh: DeviceMesh, axis: str = "data",
                         *, backend: str = "auto"):
    """Top-K Pearson with X row-sharded (DESIGN.md §17.4).

    Each rank gathers the rows of X (the one collective; rows padded to
    the axis size, pad rows never candidates) and runs the top-K kernel
    (``ops.topk``) on its own row range, the keys over all n rows: a
    range launch is bitwise those rows of the whole launch, so the table
    is the single-device table (value desc, index asc).

    Returns ``(values (n, k), indices (n, k), Z (n, L))``: the table as
    row-sharded DTensors and Z, the standardized series the sparse
    TMFG's exact-value fallback reads, replicated."""
    n, L = X.shape
    k = min(int(k), n - 1)
    xl = local_block(X, mesh, axis).float()
    row0, count = my_block(n, mesh, axis)
    xf = gather_rows(xl, n, mesh, axis)
    if count:
        v, i = ops.topk(xf, k, backend=backend, row_range=(row0, count))
    else:
        v = xf.new_empty((0, k))
        i = torch.empty((0, k), dtype=torch.int32, device=xf.device)
    rows = timeseries_spec(axis)
    return (as_dtensor(v, mesh, axis, rows, (n, k)),
            as_dtensor(i, mesh, axis, rows, (n, k)), standardize_rows(xf))


def masked_argmax_shardmap(S, mask: torch.Tensor, mesh: DeviceMesh,
                           axis: str = "data", *, backend: str = "auto"):
    """Per-row masked (max, argmax) with S *row*-sharded: the gain-scan
    kernel is independent over rows, so each rank scans its block with
    ``ops.masked_argmax`` and no collective is needed.  Returns the
    (values, indices) as row-sharded DTensors."""
    n = S.shape[0]
    v, i = ops.masked_argmax(local_block(S, mesh, axis), mask,
                             backend=backend)
    rows = timeseries_spec(axis)
    return (as_dtensor(v, mesh, axis, rows, (n,)),
            as_dtensor(i, mesh, axis, rows, (n,)))


def minplus_shardmap(A, B: torch.Tensor, mesh: DeviceMesh,
                     axis: str = "data", *,
                     backend: str = "auto") -> DTensor:
    """Tropical matmul with A row-sharded and B replicated: each rank runs
    the min-plus kernel (``ops.minplus``) on its (n/d, k) x (k, n) block
    and the result stays row-sharded, the layout the next squaring wants
    (DESIGN.md §4.3)."""
    if isinstance(B, DTensor):
        B = B.full_tensor()
    out = ops.minplus(local_block(A, mesh, axis), B, backend=backend)
    return as_dtensor(out, mesh, axis, timeseries_spec(axis),
                      (A.shape[0], B.shape[1]))
