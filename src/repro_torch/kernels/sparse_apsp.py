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
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import _build
from ._checks import require_cuda, require_int32_range, stream_of

KERNEL = _build.Kernel("repro_sparse_relax", "ppppppii")

INF = float("inf")


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


def sparse_relax_cuda(D: torch.Tensor, indptr: torch.Tensor,
                      cols: torch.Tensor, vals: torch.Tensor):
    """One relaxation round through the kernel: (out (s, n) f32, changed
    (1,) int32), where changed is 1 iff some out[s, v] < D[s, v].  D is
    not written."""
    require_cuda("D", D, torch.float32, 2)
    require_cuda("indptr", indptr, torch.int32, 1)
    require_cuda("cols", cols, torch.int32, 1)
    require_cuda("vals", vals, torch.float32, 1)
    s, n = D.shape
    m = cols.shape[0]
    if indptr.shape[0] != n + 1 or vals.shape[0] != m or not (
            D.device == indptr.device == cols.device == vals.device):
        raise ValueError(f"sparse_relax: D {tuple(D.shape)}, indptr "
                         f"{tuple(indptr.shape)}, cols {tuple(cols.shape)}, "
                         f"vals {tuple(vals.shape)} do not fit one device "
                         f"and one graph")
    require_int32_range(s=s, n=n, m=max(m, 1), sn=s * n)
    out = torch.empty_like(D)
    changed = torch.zeros(1, dtype=torch.int32, device=D.device)
    with torch.cuda.device(D.device):
        KERNEL.launch(D.data_ptr(), indptr.data_ptr(), cols.data_ptr(),
                      vals.data_ptr(), out.data_ptr(), changed.data_ptr(),
                      s, n, stream=stream_of(D))
    return out, changed


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
    Each round reads one device flag back to the host (one sync per
    round, as the reference's ``while_loop`` predicate is one device
    value per round).  ``stats``, if a dict, receives ``bf_rounds``."""
    from . import ops  # local: ops imports this module's kernel

    n = graph.n
    s = sources.shape[0]
    cap = rounds if rounds else n
    D = torch.full((s, n), INF, dtype=torch.float32,
                   device=graph.vals.device)
    D[torch.arange(s, device=D.device), sources.long()] = 0.0
    i, changed = 0, True
    while i < cap and changed:
        D, flag = ops.sparse_relax(D, graph, backend=backend)
        changed = bool(flag.item())
        i += 1
    if stats is not None:
        stats["bf_rounds"] = i
    return D
