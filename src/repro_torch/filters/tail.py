"""Generic hierarchy tail for non-TMFG filters (DESIGN.md §18.4).

The port of ``repro.filters.tail``.  DBHT proper needs the TMFG's bubble
tree, which an MST, an asset graph or the PMFG does not carry, so the
other filters share this tail, built from the TMFG path's stages:

  * distances — d = √(2(1-ρ)) on the filter's edges (the square root in
    float64, rounded once, as ``apsp.edge_lengths``); ``"exact"`` (and
    ``"hub"`` below ``HUB_MIN_N``) squares the dense length matrix with
    ``ops.minplus``; ``"hub"``/``"sparse"`` run the hub factor over the
    filter's CSR (``ops.sparse_relax_t``, one flag read a Bellman-Ford
    round), compose ``D_h.T ⊗ D_h`` with ``ops.minplus`` and floor it by
    the direct edge lengths;
  * coarse partition — connected components by min-label propagation
    to its fixed point, one flag read an iteration (an AG with a small
    budget shatters; its components stand in for DBHT's converging
    bubbles);
  * dendrogram — ``hac.hierarchical_offsets`` and one
    ``hac.complete_linkage`` (``ops.masked_argmax``, n − 1 scans), with
    cross-component pairs pushed above every intra-component merge.

:func:`filter_tail` returns the dict ``dbht._result_from_device``
unpacks.
"""

from __future__ import annotations

import torch

from repro_torch.core import apsp as apsp_mod
from repro_torch.core import hac as hac_mod
from repro_torch.core.sparse_dbht import edge_lengths_from_sim
from repro_torch.kernels import ops
from repro_torch.kernels import sparse_apsp as sparse_kernels

from .graph import FilterGraph, edge_similarities


def _distances(S: torch.Tensor, edges: torch.Tensor, *, apsp_method: str,
               apsp_hubs: int, apsp_rounds: int, backend: str,
               stats: dict) -> torch.Tensor:
    """Geodesic distances on the filtered graph, by ``apsp_method``."""
    n = S.shape[0]
    if apsp_method == "exact" or (apsp_method == "hub"
                                  and n < apsp_mod.HUB_MIN_N):
        W = apsp_mod.edge_lengths(n, edges, S)
        return apsp_mod.apsp_exact(W, backend=backend)
    d = edge_lengths_from_sim(edge_similarities(S, edges))
    graph = sparse_kernels.csr_from_edges(n, edges, d)
    _, D_h = apsp_mod.hub_factor_sparse(graph, n_hubs=apsp_hubs,
                                        rounds=apsp_rounds, backend=backend,
                                        stats=stats)
    est = ops.minplus(D_h.T.contiguous(), D_h, backend=backend)
    e = edges.long()
    flat = est.view(-1)
    flat.scatter_reduce_(0, e[:, 0] * n + e[:, 1], d, "amin")
    flat.scatter_reduce_(0, e[:, 1] * n + e[:, 0], d, "amin")
    est = torch.minimum(est, est.T)
    est.fill_diagonal_(0.0)
    return est


def _no_stage(name: str) -> None:
    """The default ``done`` hook: no stage boundary is recorded."""


def _components(n: int, edges: torch.Tensor) -> torch.Tensor:
    """Min-label connected components of the edge list: label[v] is the
    smallest vertex id in v's component (the fixed point of propagation
    and pointer-jump compression, one flag read an iteration)."""
    e = edges.long()
    e0, e1 = e[:, 0], e[:, 1]
    lab = torch.arange(n, dtype=torch.int64, device=edges.device)
    while True:
        l2 = lab.scatter_reduce(0, e0, lab[e1], "amin")
        l2.scatter_reduce_(0, e1, l2[e0], "amin")
        l2 = l2[l2]
        changed = bool((l2 != lab).any())
        lab = l2
        if not changed:
            return lab


def filter_tail(S: torch.Tensor, fg: FilterGraph, *,
                apsp_method: str = "exact", apsp_hubs: int = 0,
                apsp_rounds: int = 0, backend: str = "auto",
                done=_no_stage, stats: dict = None) -> dict:
    """APSP, components and nested HAC on a :class:`FilterGraph`.

    Returns the device-core dict (``direction``/``conv_mask``/
    ``cluster_of``/``bubble_of``/``D``/``Z``) in the
    ``dbht._result_from_device`` convention: ``conv_mask`` marks the
    component representatives (lowest vertex id), ``cluster_of`` and
    ``bubble_of`` both hold the component id, and ``direction`` is a
    length-1 placeholder.  ``done(stage)`` is called after
    "apsp", "dbht" (the components) and "hac"; ``stats``, if a dict,
    receives ``bf_rounds`` where a Bellman-Ford loop ran."""
    n = S.shape[0]
    D = _distances(S, fg.edges, apsp_method=apsp_method, apsp_hubs=apsp_hubs,
                   apsp_rounds=apsp_rounds, backend=backend, stats=stats)
    done("apsp")
    lab = _components(n, fg.edges)
    conv_mask = lab == torch.arange(n, device=lab.device)
    comp_id = torch.cumsum(conv_mask, 0) - 1
    cluster_of = comp_id[lab].to(torch.int32)
    done("dbht")
    adj = hac_mod.hierarchical_offsets(D, cluster_of, cluster_of)
    Z = hac_mod.complete_linkage(adj, backend=backend)
    del adj
    done("hac")
    return dict(direction=torch.zeros(1, dtype=torch.float32,
                                      device=S.device),
                conv_mask=conv_mask, cluster_of=cluster_of,
                bubble_of=cluster_of, D=D, Z=Z)
