"""Sparse APSP on the TMFG edge list: multi-source relaxation over a CSR.

The port of ``repro.kernels.sparse_apsp`` (DESIGN.md §14.1).  The TMFG
is planar, exactly 3n-6 edges, so the hub distances never need the
dense (n, n) length matrix: a CSR adjacency of the 2(3n-6) directed
entries and a relaxation round

    D[s, v]  <-  min(D[s, v],  min_{(u,v) in E}  D[s, u] + w(u, v))

iterated to the fixed point from a few source rows (the hubs of
``core/apsp.hub_factor_sparse``).  On the card one round is one launch
of ``csrc/sparse_relax.cu``, which fuses the gather, the add and the
segmented minimum that the JAX package splits between its Pallas tile
(``gather_add_pallas``) and an XLA scatter-min; the plain version is
``ref.sparse_relax_ref``.  Every backend reaches the same fixed point
bitwise: a minimum of exactly rounded sums does not depend on the order
in which it is taken.

The kernel works on the sources-minor layout Dt (n, sp): row v holds
vertex v's distances from the s sources, padded with +inf to sp, a
multiple of 32, so one warp gathers a neighbour's distances as whole
128-byte lines.  :func:`sparse_apsp_sources` transposes once before its
loop and once after it; :func:`sparse_relax_cuda` keeps the (s, n) API
of a single round and transposes around the kernel.  The layout and the
kernel's work items (:func:`relax_plan`, rows cut into runs of at most
32 entries) are built here, where the CPU tests reach them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import _build
from ._checks import require_cuda, require_int32_range, stream_of

KERNEL = _build.Kernel("repro_sparse_relax", "pppppppppiii")

INF = float("inf")
LANES = 32            # sources padded to a multiple of this (one warp)
ITEM = 32             # CSR entries per work item: one per lane of a warp


class CSRGraph(NamedTuple):
    """Row-sorted CSR adjacency of an undirected weighted graph (the
    reference's fields; ``rows`` is ``indptr`` run-length decoded)."""

    indptr: torch.Tensor    # (n+1,) i32 — row start offsets
    rows: torch.Tensor      # (m,) i32 — head vertex per entry, ascending
    cols: torch.Tensor      # (m,) i32 — tail vertex per entry
    vals: torch.Tensor      # (m,) f32 — edge weight per entry

    @property
    def n(self) -> int:
        return self.indptr.shape[0] - 1


def csr_from_edges(n: int, edges: torch.Tensor, w: torch.Tensor) -> CSRGraph:
    """CSR adjacency from an undirected edge list (E, 2) and weights (E,).

    Both directions of every edge become entries (2E), sorted by
    (row, col) with a stable sort, as the reference's ``lexsort``."""
    e = edges.long()
    rows = torch.cat([e[:, 0], e[:, 1]])
    cols = torch.cat([e[:, 1], e[:, 0]])
    vals = torch.cat([w, w]).float()
    order = torch.sort(rows * n + cols, stable=True).indices
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = torch.bincount(rows, minlength=n)
    indptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=e.device),
                        torch.cumsum(counts, 0)])
    return CSRGraph(indptr=indptr.int(), rows=rows.int(), cols=cols.int(),
                    vals=vals.contiguous())


def hub_strength(graph: CSRGraph) -> torch.Tensor:
    """Weighted degree per vertex: the sum of incident 1/(length + 1e-6),
    one left-to-right sum per CSR row (the reference's ``segment_sum``
    over the row-sorted entries)."""
    lengths = (graph.indptr[1:] - graph.indptr[:-1]).long()
    return torch.segment_reduce(1.0 / (graph.vals + 1e-6), "sum",
                                lengths=lengths, initial=0.0)


def source_pad(s: int) -> int:
    """The sources-minor row length for s sources: a multiple of 32."""
    return -(-s // LANES) * LANES


def to_sources_minor(D: torch.Tensor) -> torch.Tensor:
    """D (s, n) -> Dt (n, source_pad(s)), the padding +inf."""
    s, n = D.shape
    Dt = torch.full((n, source_pad(s)), INF, dtype=D.dtype, device=D.device)
    Dt[:, :s] = D.T
    return Dt


def from_sources_minor(Dt: torch.Tensor, s: int) -> torch.Tensor:
    """Dt (n, sp) -> D (s, n), the padding dropped."""
    return Dt[:, :s].T.contiguous()


class RelaxPlan(NamedTuple):
    """The kernel's work items for one graph (see ``csrc/sparse_relax.cu``):
    every CSR row cut into runs of at most ITEM entries."""

    items: torch.Tensor     # (m, 4) i32: vertex, first entry, end, slot or -1
    slots: torch.Tensor     # (max(1, p), 2) i32: vertex's first slot, items
    counters: torch.Tensor  # (max(1, p),) i32, zero between launches
    n_slots: int            # p: items of rows longer than ITEM


def relax_plan(indptr: torch.Tensor) -> RelaxPlan:
    """Cut each row of the CSR ``indptr`` (n + 1,) into items of at most
    ITEM entries; an item of a row that needs several gets a partial
    slot, numbered in item order.  Built once per graph, on its device."""
    indptr = indptr.long()
    dev = indptr.device
    n = indptr.shape[0] - 1
    deg = indptr[1:] - indptr[:-1]
    parts = torch.clamp((deg + ITEM - 1) // ITEM, min=1)
    v = torch.repeat_interleave(torch.arange(n, device=dev), parts)
    first = torch.cumsum(parts, 0) - parts
    q = torch.arange(v.shape[0], device=dev) - first[v]
    e0 = indptr[v] + q * ITEM
    e1 = torch.minimum(e0 + ITEM, indptr[v + 1])
    split = parts[v] > 1
    slot = torch.where(split, torch.cumsum(split.long(), 0) - 1, -1)
    items = torch.stack([v, e0, e1, slot], dim=1).int().contiguous()
    n_slots = int(split.sum())
    slots = torch.stack([(slot - q)[split], parts[v][split]], dim=1).int()
    if n_slots == 0:
        slots = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    return RelaxPlan(items=items, slots=slots.contiguous(),
                     counters=torch.zeros(max(1, n_slots), dtype=torch.int32,
                                          device=dev),
                     n_slots=n_slots)


def sparse_relax_t_cuda(Dt: torch.Tensor, s: int, indptr: torch.Tensor,
                        cols: torch.Tensor, vals: torch.Tensor,
                        plan: RelaxPlan, out: Optional[torch.Tensor] = None):
    """One relaxation round through the kernel on the sources-minor layout:
    (out (n, sp) f32, changed (1,) int32), where changed is 1 iff some
    out[v, j] < Dt[v, j], j < s.  Dt is not written, nor is the padding
    of ``out`` (a fresh buffer when None, else written in place)."""
    require_cuda("Dt", Dt, torch.float32, 2)
    require_cuda("indptr", indptr, torch.int32, 1)
    require_cuda("cols", cols, torch.int32, 1)
    require_cuda("vals", vals, torch.float32, 1)
    n, sp = Dt.shape
    m = cols.shape[0]
    if indptr.shape[0] != n + 1 or vals.shape[0] != m or not (
            Dt.device == indptr.device == cols.device == vals.device
            == plan.items.device):
        raise ValueError(f"sparse_relax: Dt {tuple(Dt.shape)}, indptr "
                         f"{tuple(indptr.shape)}, cols {tuple(cols.shape)}, "
                         f"vals {tuple(vals.shape)} do not fit one device "
                         f"and one graph")
    if not (0 < s <= sp and sp % LANES == 0):
        raise ValueError(f"sparse_relax: {s} sources in rows of {sp}")
    require_int32_range(s=s, n=n, m=max(m, 1), nsp=n * sp,
                        items=plan.items.shape[0])
    if out is None:
        out = torch.empty_like(Dt)
    elif out.shape != Dt.shape or out.data_ptr() == Dt.data_ptr():
        raise ValueError("sparse_relax: out must be another (n, sp) buffer")
    require_cuda("out", out, torch.float32, 2)
    changed = torch.zeros(1, dtype=torch.int32, device=Dt.device)
    partial = torch.empty((max(1, plan.n_slots), sp), dtype=torch.float32,
                          device=Dt.device)
    with torch.cuda.device(Dt.device):
        KERNEL.launch(Dt.data_ptr(), out.data_ptr(), plan.items.data_ptr(),
                      plan.slots.data_ptr(), plan.counters.data_ptr(),
                      partial.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                      changed.data_ptr(), s, sp,
                      plan.items.shape[0], stream=stream_of(Dt))
    return out, changed


def sparse_relax_cuda(D: torch.Tensor, indptr: torch.Tensor,
                      cols: torch.Tensor, vals: torch.Tensor,
                      plan: Optional[RelaxPlan] = None):
    """One relaxation round through the kernel on D (s, n): (out (s, n)
    f32, changed (1,) int32), transposed to the sources-minor layout and
    back around the launch.  D is not written."""
    require_cuda("D", D, torch.float32, 2)
    require_cuda("indptr", indptr, torch.int32, 1)
    s = D.shape[0]
    out, changed = sparse_relax_t_cuda(
        to_sources_minor(D), s, indptr, cols, vals,
        relax_plan(indptr) if plan is None else plan)
    return from_sources_minor(out, s), changed


def sparse_relax(D: torch.Tensor, graph: CSRGraph, *,
                 backend: str = "auto") -> torch.Tensor:
    """One multi-source relaxation round: ``min(D, candidates)``."""
    from . import ops  # local: ops imports this module's kernel

    return ops.sparse_relax(D, graph, backend=backend)[0]


def sparse_apsp_sources(graph: CSRGraph, sources: torch.Tensor, *,
                        rounds: int = 0, backend: str = "auto",
                        stats: Optional[dict] = None) -> torch.Tensor:
    """Distances (s, n) from ``sources`` by iterated sparse relaxation.

    Stops at the first round that changes nothing (the fixed point);
    ``rounds=0`` caps at n, a nonzero cap truncates, as in the reference.
    The loop runs on the sources-minor layout (one transpose before it,
    one after it), one launch per round on the card.  Each round reads
    one device flag back to the host (one sync per round, as the
    reference's ``while_loop`` predicate is one device value per round).
    ``stats``, if a dict, receives ``bf_rounds``."""
    from . import ops  # local: ops imports this module's kernel

    n = graph.n
    s = sources.shape[0]
    cap = rounds if rounds else n
    dev = graph.vals.device
    Dt = torch.full((n, source_pad(s)), INF, dtype=torch.float32, device=dev)
    Dt[sources.long(), torch.arange(s, device=dev)] = 0.0
    plan = spare = None
    if ops.use_kernel(Dt, backend):
        # two buffers in turn; the kernel never writes their +inf padding
        plan, spare = relax_plan(graph.indptr), torch.full_like(Dt, INF)
    i, changed = 0, True
    while i < cap and changed:
        out, flag = ops.sparse_relax_t(Dt, s, graph, plan=plan, out=spare,
                                       backend=backend)
        Dt, spare = out, (Dt if spare is not None else None)
        changed = bool(flag.item())
        i += 1
    if stats is not None:
        stats["bf_rounds"] = i
    return from_sources_minor(Dt, s)
