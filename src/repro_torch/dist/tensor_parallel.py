"""Tensor parallelism over the mesh's ``model`` dim: the work of a dense,
MoE or VLM layer split over the model ranks, as the reference's GSPMD
program splits it (DESIGN.md §7.1, §8).

``dist.sharding.param_specs`` stores each leaf tensor-parallel over
``model`` and FSDP over ``(pod, data)``.  The mesh train step and the
dry run's serving steps hand the model its leaves as stored (DTensors)
and bind ``model_ranks`` (:func:`bind`).  The model asks for a leaf's
*compute block* where it uses it (:func:`weight`, a layer at a time
inside the function ``layers.remat`` checkpoints), in two steps, each
an autograd function that saves no tensor for the backward:

  1. :class:`_DataGather` gathers the leaf's block over the data dims,
     keeping its model shard.  Its backward sums the gradient over the
     data ranks back into the stored block: a reduce-scatter over a dim
     that shards the leaf, an all-reduce over one that replicates it.
  2. :class:`_ModelBlock` turns the model shard into the rank's
     :class:`Block`: nothing where the stored shard is the block; an
     all-to-all where the block lies along another dim (``wo`` and the
     down projections are stored split on their output dim, the
     embedding on d_model, and computed split on their input dim and
     the vocabulary); else the shard gathered over the model ranks and
     the block cut out of it.  Its backward is the adjoint: the
     gradient of a ``partial`` block is summed over the model ranks (a
     kv head that ranks share, a head that ``H < t`` ranks compute, a
     leaf stored whole); a whole block of the replicated region (the
     norms, the router) has its whole gradient on every rank, which
     keeps its stored part.

Activations cross the model ranks through Megatron's pair:
:func:`enter` (the identity; its backward sums the input's gradient
over the model ranks) before a split product, and :func:`leave` (a sum
over the model ranks; its backward the identity) after a row-parallel
one.  :func:`gather_last` concatenates the ranks' column blocks of an
output (its backward keeps the rank's).  :func:`embed_lookup` and
:func:`vocab_ce` are the vocabulary-parallel lookup and cross entropy.

Unbound, every helper is the identity, and so is each at degree 1
except :func:`weight`'s gather over the data ranks, so a single-device
path is bitwise what it was.  A collective over one rank is skipped.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterator, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from . import hints
from .sharding import all_gather_flat


def current() -> Optional[hints.ModelRanks]:
    """The ``model_ranks`` binding, or None."""
    return hints.get("model_ranks")


def degree() -> int:
    """t, the number of model ranks (1 when unbound)."""
    tp = current()
    return 1 if tp is None else tp.size


@contextlib.contextmanager
def bind(mesh) -> Iterator[hints.ModelRanks]:
    """Bind ``model_ranks`` to ``mesh``'s ``model`` dim (degree 1 where
    it has none) for the dynamic scope."""
    names = tuple(mesh.mesh_dim_names or ())
    if "model" in names and mesh.size(names.index("model")) > 1:
        i = names.index("model")
        ranks = hints.ModelRanks(mesh.size(i), mesh.get_coordinate()[i],
                                 mesh.get_group(i), mesh, i)
    else:
        ranks = hints.ModelRanks(1, 0, None, mesh,
                                 names.index("model") if "model" in names
                                 else None)
    with hints.hints(model_ranks=ranks):
        yield ranks


# ---------------------------------------------------------------------------
# collectives on plain tensors
# ---------------------------------------------------------------------------

def _lead(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with ``dim`` first, contiguous."""
    return (x if dim == 0 else x.movedim(dim, 0)).contiguous()


def _gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The n ranks' blocks of ``x`` along ``dim``, in rank order."""
    x = _lead(x, dim)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    all_gather_flat(out, x, group)
    return out if dim == 0 else out.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, group,
                    n: int) -> torch.Tensor:
    """The sum of ``x`` over the n ranks, this rank's block along
    ``dim``."""
    x = _lead(x, dim)
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(out, x, group=group)
    return out if dim == 0 else out.movedim(0, dim).contiguous()


def _all_reduce(x: torch.Tensor, group,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``x`` reduced over the ranks of ``group``."""
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=op, group=group)
    return x


def _all_to_all(x: torch.Tensor, src: int, dst: int, group,
                n: int) -> torch.Tensor:
    """From this rank's block along ``src`` (``x``, whole along ``dst``)
    to its block along ``dst``, whole along ``src``."""
    send = _lead(x.unflatten(dst, (n, x.shape[dst] // n)), dst)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.movedim(0, src).flatten(src, src + 1).contiguous()


# ---------------------------------------------------------------------------
# compute blocks of stored leaves
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Block:
    """A rank's compute block of a leaf: ``size`` entries from ``start``
    along ``dim``, or the whole leaf (``dim`` None).  ``partial``: the
    ranks' gradients of their blocks are parts of the leaf's, summed over
    the model ranks; else every rank's is the whole leaf's (the
    replicated region)."""
    dim: Optional[int] = None
    start: int = 0
    size: int = 0
    partial: bool = True


# the replicated region's leaves: whole on every rank
WHOLE = Block(partial=False)


def split(dim: int, n: int) -> Block:
    """This rank's even block of the ``n`` entries along ``dim``."""
    tp = current()
    t = 1 if tp is None else tp.size
    if n % t:
        raise ValueError(f"{n} entries along dim {dim} do not split over "
                         f"{t} model ranks")
    return Block(dim, (0 if tp is None else tp.index) * (n // t), n // t)


class _DataGather(torch.autograd.Function):
    """A stored block gathered over the data dims (``dims``: (group,
    ranks, the tensor dim the mesh dim shards or None) a data mesh dim,
    in mesh order); backward: summed over the data ranks, back into the
    stored block."""

    @staticmethod
    def forward(ctx, x, dims):
        ctx.dims = dims
        # innermost first: the nested shards of one tensor dim are
        # pod-major
        out = x
        for group, n, d in reversed(dims):
            if d is not None:
                out = _gather(out, d, group, n)
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(ctx, g):
        for group, n, d in ctx.dims:
            g = _all_reduce(g, group) if d is None \
                else _reduce_scatter(g, d, group, n)
        return g, None


class _ModelBlock(torch.autograd.Function):
    """A leaf's model shard (``x``: its stored block along tensor dim
    ``s`` of ``shape``, or the whole leaf where ``s`` is None) to this
    rank's compute ``block``; backward: the adjoint (module docstring)."""

    @staticmethod
    def forward(ctx, x, tp, s, shape, block):
        ctx.args = (tp, s, shape, block)
        route = _route(tp, s, shape, block)
        if route == "same":
            return x.view_as(x)
        if route == "all_to_all":
            return _all_to_all(x, s, block.dim, tp.group, tp.size)
        if s is not None:
            x = _gather(x, s, tp.group, tp.size)
        if block.dim is None:
            return x.view_as(x)
        return x.narrow(block.dim, block.start, block.size).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        tp, s, shape, block = ctx.args
        route = _route(tp, s, shape, block)
        if route == "same":
            return g, None, None, None, None
        if route == "all_to_all":
            return _all_to_all(g, block.dim, s, tp.group, tp.size), \
                None, None, None, None
        if not block.partial:
            # every rank holds the whole gradient: it keeps its part
            if s is not None:
                n = shape[s] // tp.size
                g = g.narrow(s, tp.index * n, n).contiguous()
            return g, None, None, None, None
        if block.dim is not None:
            full = g.new_zeros(shape)
            full.narrow(block.dim, block.start, block.size).copy_(g)
            g = full
        g = _all_reduce(g, tp.group) if s is None \
            else _reduce_scatter(g, s, tp.group, tp.size)
        return g, None, None, None, None


def _route(tp, s, shape, block) -> str:
    """How a model shard along ``s`` becomes ``block``: "same" (it is the
    block), "all_to_all" (the even block along another dim) or
    "gather" (the shard gathered, the block cut out)."""
    if s is None or block.dim is None:
        return "gather"
    n = shape[s] // tp.size
    if block.dim == s and (block.start, block.size) == (tp.index * n, n):
        return "same"
    m = shape[block.dim] // tp.size
    if block.dim != s and shape[block.dim] % tp.size == 0 \
            and (block.start, block.size) == (tp.index * m, m):
        return "all_to_all"
    return "gather"


def weight(x, block: Block = WHOLE) -> torch.Tensor:
    """The compute ``block`` of leaf ``x`` on this rank: for a stored
    DTensor under ``model_ranks`` its block gathered over the data dims
    and turned into the block over the model ranks (differentiable,
    saving no tensor); else ``x`` itself (a single-device leaf)."""
    tp = current()
    if tp is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    local = x.to_local()
    dims = tuple((mesh.get_group(i), mesh.size(i),
                  p.dim if isinstance(p, Shard) else None)
                 for i, p in enumerate(x.placements)
                 if i != tp.dim and mesh.size(i) > 1)
    if dims:
        local = _DataGather.apply(local, dims)
    if tp.size == 1:
        return local
    p = x.placements[tp.dim]
    s = p.dim if isinstance(p, Shard) else None
    shape = tuple(x.shape)
    if (s is None and block.dim is None and not block.partial) \
            or _route(tp, s, shape, block) == "same":
        return local
    return _ModelBlock.apply(local, tp, s, shape, block)


def blocks(tree, spec):
    """:func:`weight` over a dict of leaves, ``spec`` a dict of the same
    keys holding each leaf's :class:`Block`."""
    if current() is None:
        return tree
    return {k: blocks(v, spec[k]) if isinstance(v, dict) else
            weight(v, spec[k]) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# activations across the model ranks
# ---------------------------------------------------------------------------

class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.n = tp, x.shape[-1]
        return _gather(x, x.dim() - 1, tp.group, tp.size)

    @staticmethod
    def backward(ctx, g):
        n = ctx.n
        return g.narrow(-1, ctx.tp.index * n, n).contiguous(), None


def _split_on() -> Optional[hints.ModelRanks]:
    tp = current()
    return tp if tp is not None and tp.size > 1 else None


def enter(x: torch.Tensor) -> torch.Tensor:
    """``x``, replicated over the model ranks, entering a split product:
    the backward sums its gradient over them."""
    tp = _split_on()
    return x if tp is None else _Enter.apply(x, tp.group)


def leave(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model ranks of their parts ``x`` of a
    row-parallel product (the backward: the identity)."""
    tp = _split_on()
    return x if tp is None else _Leave.apply(x, tp.group)


def gather_last(x: torch.Tensor) -> torch.Tensor:
    """The model ranks' column blocks ``x`` concatenated along the last
    dim, in rank order (the backward keeps this rank's)."""
    tp = _split_on()
    return x if tp is None else _GatherLast.apply(x, tp)


def own_part(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This rank's even block of ``x`` along ``dim`` (``x`` replicated
    over the model ranks)."""
    tp = _split_on()
    if tp is None:
        return x
    n = x.shape[dim] // tp.size
    return x.narrow(dim, tp.index * n, n)


def only_owner(x: torch.Tensor, owner: bool) -> torch.Tensor:
    """``x`` where this rank owns the work, else zeros that keep the
    graph (every rank's backward runs the same collectives)."""
    return x if owner else x * 0


def all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the model ranks (no gradient)."""
    tp = _split_on()
    return x if tp is None else _all_reduce(x, tp.group, op)


# ---------------------------------------------------------------------------
# the vocabulary over the model ranks
# ---------------------------------------------------------------------------

def embed_lookup(E: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``embed[tokens]`` with ``E`` this rank's vocabulary rows: each rank
    looks up its own rows, zeros elsewhere, and the sum over the ranks
    has exactly one nonzero term (bitwise the lookup)."""
    tp = _split_on()
    if tp is None:
        return E[tokens]
    Vl = E.shape[0]
    local = tokens - tp.index * Vl
    inside = (local >= 0) & (local < Vl)
    x = E[torch.where(inside, local, 0)]
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))
    return leave(x)


def vocab_ce(logits: torch.Tensor, targets: torch.Tensor,
             vocab: int) -> torch.Tensor:
    """The mean next-token cross entropy of this rank's vocabulary block
    of fp32 logits (..., Vp / t), the padded vocabulary masked: the max,
    the sum of exponentials and the gold logit reduced over the model
    ranks."""
    tp = _split_on()
    Vl = logits.shape[-1]
    lo = tp.index * Vl
    cols = torch.arange(lo, lo + Vl, device=logits.device)
    logits = torch.where(cols < vocab, logits, -1e30)
    mx = all_reduce(logits.detach().amax(-1, keepdim=True),
                    dist.ReduceOp.MAX)
    se = leave(torch.exp(logits - mx).sum(-1))
    lse = torch.log(se) + mx[..., 0]
    local = targets.long() - lo
    inside = (local >= 0) & (local < Vl)
    gold = logits.gather(-1, torch.where(inside, local, 0)[..., None])[..., 0]
    gold = leave(torch.where(inside, gold, 0.0))
    return (lse - gold).mean()
