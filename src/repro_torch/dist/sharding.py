"""Mesh-aware placement over ``torch.distributed`` (DESIGN.md §4.4, §7.1).

The port of ``repro.dist.sharding``, both halves.

**Clustering pipeline.**  The canonical layouts of the paper's arrays and
the sharded entry points of its three dense kernels.  The reference runs
one controller over global arrays; the port runs SPMD: every rank calls
an entry point with the same full input (or a ``DTensor`` already laid
out as the entry point wants), works on its own block with explicit
collectives, and returns its block as a ``DTensor`` whose
``full_tensor()`` is the reference's global array.  A mesh is a
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

**LM zoo.**  :func:`param_specs` gives every parameter (and optimizer
state) leaf the reference's layout: tensor parallelism over ``model``,
FSDP / ZeRO-3 over ``(pod, data)``, leaves under ``_MIN_SHARD_ELEMS``
replicated.  A spec is a tuple of DTensor placements, one per mesh
dimension: the reference's ``PartitionSpec`` entry ``("pod", "data")``
on tensor dim d is ``Shard(d)`` on both mesh dims, which DTensor splits
in mesh order, pod-major, as JAX does.  A sharding is a
:class:`NamedSharding`, the (mesh, placements) pair that
``DTensor.from_local`` and ``distribute_tensor`` take.  The rules read
only the mesh's dim names and sizes and each leaf's ``.shape``, so an
:class:`AbstractMesh` and meta tensors serve as the reference's
``AbstractMesh`` and ``ShapeDtypeStruct`` s do.

The reference stacks a model's layers into (L, ...) leaves; the port
keeps a list of per-layer dicts (``interop.params_from_jax``).  Such a
leaf takes the reference's spec of the stacked (L, ...) leaf without its
first entry: the rules run on the stacked shape, under the reference's
names (the list index dropped), so that its size threshold and its name
rule (``"layers"`` exactly: the stack's leading axis is never sharded,
while ``enc_layers`` and ``dec_layers`` are not so named) are the
reference's.  A list that the reference keeps as a list (xLSTM's
``layers``) is a list in both, its index a path name.
:func:`batch_specs` shards a batch's leading axis over the data axes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from repro_torch.kernels import ops
from repro_torch.kernels.ref import standardize_rows
from repro_torch.train.tree import (_children, _is_node, leaves_up_to,
                                   leaves_with_paths, tree_map, unflatten)


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


# ---------------------------------------------------------------------------
# LM parameter placement
# ---------------------------------------------------------------------------

# leaves smaller than this many elements are simply replicated: sharding
# them saves nothing and costs a collective on every use
_MIN_SHARD_ELEMS = 1 << 16


class AbstractMesh:
    """A mesh's dim names and sizes, with no devices and no process group:
    the port of ``jax.sharding.AbstractMesh``, for reading the placement
    rules at a mesh this process cannot build (the production meshes on
    one card).  It answers the ``DeviceMesh`` calls the rules make."""

    def __init__(self, shape, axes):
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(axes)
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"shape {self.shape} and axes "
                             f"{self.mesh_dim_names} differ in length")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return math.prod(self.shape) if mesh_dim is None \
            else self.shape[mesh_dim]

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape}, {self.mesh_dim_names})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout: its mesh and one DTensor placement per mesh
    dimension (the port of ``jax.sharding.NamedSharding``)."""

    mesh: Any
    placements: Tuple[Placement, ...]

    def place(self, t: torch.Tensor) -> DTensor:
        """``t``, a tensor every rank holds whole, as a DTensor laid out
        so: each rank keeps its block, with no collective."""
        return from_whole(t, self.mesh, self.placements)


def _assign(spec, shape, dim_order, axes, size, taken) -> bool:
    """Put ``axes`` on the first dim in ``dim_order`` it divides; mutate
    ``spec``/``taken`` and report success."""
    if size <= 1:
        return False
    for i in dim_order:
        if i in taken:
            continue
        if shape[i] % size == 0:
            spec[i] = axes if isinstance(axes, str) or len(axes) > 1 \
                else axes[0]
            taken.add(i)
            return True
    return False


def _fsdp_assign(spec, shape, dim_order, mesh, taken) -> bool:
    """FSDP axis assignment with graceful narrowing: try the full
    (pod, data) product, then single axes widest-first (data before pod:
    the wide axis beats the narrow one on per-device memory when the full
    product does not divide)."""
    groups = [data_axes(mesh)]
    if len(groups[0]) > 1:
        groups += [(a,) for a in
                   sorted(groups[0], key=lambda a: -axis_size(mesh, a))]
    for axes in groups:
        if axes and _assign(spec, shape, dim_order, tuple(axes),
                            axis_size(mesh, axes), taken):
            return True
    return False


def _leaf_spec(names, shape, mesh, embed_mode, weights_mode) -> list:
    """The reference's ``PartitionSpec`` of one leaf as a list, one entry
    per tensor dim: None, an axis name, or a tuple of axis names."""
    ndim = len(shape)
    if ndim == 0 or math.prod(shape) < _MIN_SHARD_ELEMS:
        return [None] * ndim

    model = axis_size(mesh, "model") \
        if "model" in (mesh.mesh_dim_names or ()) else 1
    spec = [None] * ndim
    taken = set()

    # never shard the stacked-layer leading axis (the reference scans
    # over it)
    stacked = "layers" in names and ndim >= 2
    dims = list(range(1 if stacked else 0, ndim))

    if "embed" in names and ndim >= 2 and not stacked:
        # (vocab_padded, d_model); vocab is padded to a multiple of 128 so
        # that both axes divide (configs/base.py vocab_padded)
        if embed_mode in ("2d", "dmodel") and model > 1:
            _assign(spec, shape, [ndim - 1], "model", model, taken)
        if embed_mode in ("2d", "vdata"):
            _fsdp_assign(spec, shape, [0], mesh, taken)
        return spec

    # tensor parallelism: the last dimension that divides the model axis
    if model > 1:
        _assign(spec, shape, list(reversed(dims)), "model", model, taken)

    # FSDP / ZeRO-3 over (pod, data): the largest remaining divisible dim;
    # weights_mode="tp_only" (ZeRO-1) keeps parameters TP-sharded only
    if weights_mode != "tp_only":
        order = sorted((i for i in dims if i not in taken),
                       key=lambda i: -shape[i])
        _fsdp_assign(spec, shape, order, mesh, taken)
    return spec


def placements_of(dim_spec, mesh) -> Tuple[Placement, ...]:
    """A per-tensor-dim spec (the reference's ``PartitionSpec`` entries)
    as one placement per mesh dim: ``Shard(d)`` on each mesh dim named at
    tensor dim d, ``Replicate()`` on the others."""
    out = []
    for name in mesh.mesh_dim_names:
        d = next((i for i, e in enumerate(dim_spec)
                  if e == name or (isinstance(e, tuple) and name in e)),
                 None)
        out.append(Replicate() if d is None else Shard(d))
    return tuple(out)


def _homogeneous(items) -> bool:
    """Whether a list of layer trees share one structure of shapes, as
    the layers that the reference stacks into (L, ...) leaves do."""
    sig = [[(k, tuple(v.shape)) for k, v in leaves_with_paths(t)]
           for t in items]
    return bool(items) and all(s == sig[0] for s in sig)


def _leaf_infos(tree) -> list:
    """[(names, stack length or None, leaf)] in leaf order.  ``names``
    are the reference's path names: a list that the reference stacks (a
    dict's list of layer trees of one structure: a model's ``stacked``
    keys) contributes no index, and its length is the stack's."""
    out = []

    def walk(t, names, L):
        if not _is_node(t):
            out.append((names, L, t))
            return
        for k, v in _children(t):
            if (L is None and isinstance(t, dict) and isinstance(v, list)
                    and _homogeneous(v)):
                for item in v:
                    walk(item, names + (k,), len(v))
            else:
                walk(v, names + (k,), L)

    walk(tree, (), None)
    return out


def _dim_spec(names, shape, L, mesh, embed_mode, weights_mode) -> list:
    """One leaf's per-tensor-dim spec: the reference's, and for a layer of
    a stack (``L`` its length) the reference's spec of the stacked
    (L, ...) leaf without its first entry."""
    shape = tuple(int(s) for s in shape)
    if L is None:
        return _leaf_spec(names, shape, mesh, embed_mode, weights_mode)
    return _leaf_spec(names, (L,) + shape, mesh, embed_mode,
                      weights_mode)[1:]


def param_specs(params: Any, mesh, *, embed_mode: str = "2d",
                weights_mode: str = "2d") -> Any:
    """A spec (a tuple of placements, one per mesh dim) for every leaf of a
    parameter or optimizer-state tree.

    Args:
      params: a tree (``train/tree.py``) of tensors, meta tensors or any
        leaves with a ``.shape``.
      mesh: a ``DeviceMesh`` or an :class:`AbstractMesh`; missing axes are
        skipped.
      embed_mode: "2d" (vocab over the FSDP axes and d_model over model;
        the default), "dmodel" (model only; pairs with the one-hot-embed
        hint) or "vdata" (vocab over data only).
      weights_mode: "2d" (TP + FSDP; the default) or "tp_only" (ZeRO-1:
        parameters TP-sharded only; give the optimizer state the default
        2-D layout).

    Every assigned axis divides its dim; a 1-rank mesh gives replicated
    specs everywhere."""
    specs = [placements_of(_dim_spec(names, leaf.shape, L, mesh,
                                     embed_mode, weights_mode), mesh)
             for names, L, leaf in _leaf_infos(params)]
    return unflatten(params, specs)


def param_shardings(params: Any, mesh, *, embed_mode: str = "2d",
                    weights_mode: str = "2d") -> Any:
    """:func:`param_specs` as :class:`NamedSharding` leaves."""
    specs = param_specs(params, mesh, embed_mode=embed_mode,
                        weights_mode=weights_mode)
    return unflatten(params, [NamedSharding(mesh, s)
                              for s in leaves_up_to(params, specs)])


# ---------------------------------------------------------------------------
# batch placement
# ---------------------------------------------------------------------------

def batch_specs(mesh, batch: Any) -> Any:
    """Batch leaves shard dim 0 over the data axes when it divides.

    Meshes without a ``pod``/``data`` axis fall back to the mesh's first
    axis; leaves whose batch dim does not divide replicate."""
    axes = data_axes(mesh) or tuple(mesh.mesh_dim_names)[:1]
    total = axis_size(mesh, axes)

    def leaf(x):
        shape = tuple(x.shape)
        if axes and shape and shape[0] > 1 and shape[0] % total == 0:
            return placements_of((axes,) + (None,) * (len(shape) - 1),
                                 mesh)
        return (Replicate(),) * len(mesh.mesh_dim_names)

    return tree_map(leaf, batch)


def batch_shardings(mesh, batch: Any) -> Any:
    """:func:`batch_specs` as :class:`NamedSharding` leaves."""
    specs = leaves_up_to(batch, batch_specs(mesh, batch))
    return unflatten(batch, [NamedSharding(mesh, s) for s in specs])


# ---------------------------------------------------------------------------
# DTensor leaves
# ---------------------------------------------------------------------------

def shard_of(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``placements``:
    each ``Shard(d)`` taken in mesh order, as DTensor splits nested shards
    (pod-major for two mesh dims on one tensor dim), ceil(n / k) rows a
    block."""
    coords = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            start, size = block(t.shape[p.dim], mesh.size(i), coords[i])
            t = t.narrow(p.dim, start, size)
    return t


def from_whole(t: torch.Tensor, mesh, placements) -> DTensor:
    """The DTensor of global value ``t`` (held whole by every rank) laid
    out by ``placements``: each rank keeps its block, with no
    collective."""
    placements = tuple(placements)
    return DTensor.from_local(
        shard_of(t, mesh, placements), mesh, placements, run_check=False,
        shape=t.shape, stride=torch.empty(t.shape, device="meta").stride())


def whole(x) -> torch.Tensor:
    """A DTensor gathered whole (``full_tensor``); a tensor unchanged."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def local(x) -> torch.Tensor:
    """A DTensor's block on this rank; a tensor unchanged."""
    return x.to_local() if isinstance(x, DTensor) else x
