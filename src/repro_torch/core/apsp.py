"""All-pairs shortest paths on the TMFG — exact and hub-approximate.

The port of ``repro.core.apsp`` for the dense methods (DESIGN.md §4.3):

  * exact: ⌈log2(n-1)⌉ min-plus squarings of the length matrix;
  * hub:   Bellman-Ford rounds on the h hub rows, each one (h, n) x (n, n)
           min-plus product, run to the fixed point, then the composition
           ``D[u,v] ≈ min_h D[u,h] + D[h,v]`` — an (n, h) x (h, n) min-plus —
           floored by the direct edge lengths.

Every product goes through ``kernels.ops.minplus`` (the CUDA kernel on
the card).  The Bellman-Ford convergence test is one host sync per round,
as the ``lax.while_loop`` predicate is one device value per round in the
reference.

The sparse hub factor (``hub_factor_sparse``, DESIGN.md §14.2) runs the
same fixed point over the 2(3n-6) CSR entries of the TMFG with
``kernels.sparse_apsp`` (``ops.sparse_relax``, the CUDA kernel on the
card), in O(h·n + E) memory; ``apsp_sparse`` densifies it, which
``apsp(method="sparse")`` returns, as in the reference.  The pipeline's
sparse tail (``core/sparse_dbht.py``) consumes the factor itself.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import sparse_apsp as sparse_kernels

INF = float("inf")

# Below this size ``apsp(method="hub")`` runs the exact program instead,
# as in the reference (whose threshold was measured for its own
# compile-and-dispatch costs; the port keeps the value so both packages
# compute the same answer at every n).
HUB_MIN_N = 200


def hub_count(n: int, n_hubs: int = 0) -> int:
    """``n_hubs`` or the paper's ceil(sqrt(n)) default (floored at 4),
    clamped to n."""
    h = n_hubs if n_hubs > 0 else max(4, math.ceil(math.sqrt(n)))
    return min(h, n)


def edge_lengths(n: int, edges: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """Dense length matrix of the TMFG: d = sqrt(2(1-rho)) on edges.

    Non-edges are +inf, the diagonal is 0."""
    e = edges.long()
    rho = torch.clamp(S[e[:, 0], e[:, 1]].float(), -1.0, 1.0)
    # sqrt in float64, rounded once to float32: the correctly rounded
    # float32 sqrt on every device (PyTorch's vectorized CPU sqrt is off
    # by one ulp for about 0.6% of float32 inputs; XLA's is exact)
    w = torch.sqrt(torch.clamp(2.0 * (1.0 - rho), min=0.0).double()).float()
    W = torch.full((n, n), INF, dtype=torch.float32, device=S.device)
    W[e[:, 0], e[:, 1]] = w
    W[e[:, 1], e[:, 0]] = w
    W.fill_diagonal_(0.0)
    return W


def apsp_exact(W: torch.Tensor, *, backend: str = "auto") -> torch.Tensor:
    """Exact APSP by repeated min-plus squaring (W symmetric, 0 diagonal).

    Each squaring writes a fresh buffer; W is not changed."""
    n = W.shape[0]
    steps = max(1, math.ceil(math.log2(max(n - 1, 2))))
    D = W.float()
    for _ in range(steps):
        D = ops.minplus(D, D, backend=backend)
    return D


def hub_rows(W: torch.Tensor, n_hubs: int = 0) -> torch.Tensor:
    """The h hub vertices: highest weighted degree (sum of finite incident
    1/length), ties to the lowest index as in ``lax.top_k``."""
    h = hub_count(W.shape[0], n_hubs)
    finite = torch.isfinite(W) & (W > 0)
    inv = torch.reciprocal(W + 1e-6)
    strength = torch.where(finite, inv, 0.0).sum(dim=1)
    return torch.sort(strength, descending=True, stable=True)[1][:h]


def apsp_hub(W: torch.Tensor, *, n_hubs: int = 0, rounds: int = 0,
             backend: str = "auto", stats: dict = None) -> torch.Tensor:
    """Hub-based approximate APSP (paper optimization C3).

    Args:
      W: dense (n, n) length matrix (inf off-graph, 0 diagonal).
      n_hubs: number of hub vertices; 0 means ceil(sqrt(n)).
      rounds: Bellman-Ford cap; 0 relaxes to the fixed point (cap n).
      stats: if a dict, receives ``bf_rounds``, the rounds run.
    """
    n = W.shape[0]
    cap = rounds if rounds else n
    hubs = hub_rows(W, n_hubs)
    D_h = W.index_select(0, hubs)                        # (h, n)
    i, changed = 0, True
    while i < cap and changed:
        D2 = torch.minimum(D_h, ops.minplus(D_h, W, backend=backend))
        changed = bool((D2 < D_h).any())                 # one sync per round
        D_h = D2
        i += 1
    if stats is not None:
        stats["bf_rounds"] = i
    est = ops.minplus(D_h.T.contiguous(), D_h, backend=backend)   # (n, n)
    torch.minimum(est, W, out=est)                       # in place: no copy
    est = torch.minimum(est, est.T)
    est.fill_diagonal_(0.0)
    return est


def hub_factor_sparse(graph: sparse_kernels.CSRGraph, *, n_hubs: int = 0,
                      rounds: int = 0, backend: str = "auto",
                      stats: dict = None):
    """Hub factorization of sparse APSP: ``(hubs (h,), D_h (h, n))``.

    The weighted-degree hubs of :func:`hub_rows` from the CSR form of the
    strength (``sparse_apsp.hub_strength``), ties to the lowest index,
    and the Bellman-Ford fixed point from them over the CSR entries
    (``rounds=0`` caps at n).  Any distance is then
    ``min(min_h D_h[h, u] + D_h[h, v], w(u, v) if an edge)``.
    ``stats``, if a dict, receives ``bf_rounds``."""
    h = hub_count(graph.n, n_hubs)
    strength = sparse_kernels.hub_strength(graph)
    hubs = torch.sort(strength, descending=True, stable=True)[1][:h]
    D_h = sparse_kernels.sparse_apsp_sources(graph, hubs, rounds=rounds,
                                             backend=backend, stats=stats)
    return hubs, D_h


def csr_from_dense(W: torch.Tensor) -> sparse_kernels.CSRGraph:
    """CSR adjacency from a dense length matrix (finite off-diagonal
    entries are edges, taken from the upper triangle in row-major order,
    as the reference's ``np.triu_indices``)."""
    n = W.shape[0]
    iu, ju = torch.triu_indices(n, n, 1, device=W.device)
    w = W[iu, ju].float()
    keep = torch.isfinite(w)
    edges = torch.stack([iu[keep], ju[keep]], dim=1).int()
    return sparse_kernels.csr_from_edges(n, edges, w[keep])


def apsp_sparse(W: torch.Tensor, *, n_hubs: int = 0, rounds: int = 0,
                backend: str = "auto", stats: dict = None) -> torch.Tensor:
    """Sparse hub APSP densified back to (n, n), for parity tests: the hub
    factor of W's CSR composed as ``min_h D_h[:, u] + D_h[:, v]`` with
    :func:`apsp_hub`'s edge floor, symmetrization and zero diagonal."""
    _, D_h = hub_factor_sparse(csr_from_dense(W), n_hubs=n_hubs,
                               rounds=rounds, backend=backend, stats=stats)
    est = ops.minplus(D_h.T.contiguous(), D_h, backend=backend)
    torch.minimum(est, W.float(), out=est)
    est = torch.minimum(est, est.T)
    est.fill_diagonal_(0.0)
    return est


def apsp(W: torch.Tensor, *, method: str = "hub", n_hubs: int = 0,
         rounds: int = 0, backend: str = "auto",
         stats: dict = None) -> torch.Tensor:
    """Dispatch to exact / hub / sparse APSP by ``method``; below
    HUB_MIN_N vertices ``method="hub"`` runs the exact program, as in
    the reference.  ``method="sparse"`` is :func:`apsp_sparse` at every
    n."""
    if method == "exact" or (method == "hub" and W.shape[0] < HUB_MIN_N):
        return apsp_exact(W, backend=backend)
    if method == "hub":
        return apsp_hub(W, n_hubs=n_hubs, rounds=rounds, backend=backend,
                        stats=stats)
    if method == "sparse":
        return apsp_sparse(W, n_hubs=n_hubs, rounds=rounds, backend=backend,
                           stats=stats)
    raise ValueError(f"unknown APSP method {method!r}")
