"""FilterGraph — the one result contract of the filter matrix (DESIGN.md §18.1).

The port of ``repro.filters.graph``.  Every filter front-end (MST, PMFG,
Asset Graph) reduces the (n, n) similarity matrix to an edge list and
the similarity of each edge, which is all the §18.4 tail consumes; a
:class:`FilterGraph` takes the ``tmfg`` slot of a ``ClusterResult``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FilterGraph(NamedTuple):
    """Edge-list form of a filtered graph: ``edges`` rows are canonical
    (i < j) and every row is a real edge (MST: n-1, PMFG: 3n-6, AG: m)."""

    edges: torch.Tensor     # (E, 2) i32, canonical i < j rows
    weights: torch.Tensor   # (E,) f32 — similarity S[i, j] per edge
    edge_sum: torch.Tensor  # () f32 — total similarity captured

    def adjacency(self, n: int) -> torch.Tensor:
        """Dense (n, n) weighted adjacency (0 off-graph), as
        ``tmfg.adjacency_from_weights`` builds it for the TMFG."""
        from repro_torch.core.tmfg import adjacency_from_weights
        return adjacency_from_weights(n, self.edges, self.weights)


def edge_similarities(S: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Per-edge similarity gather shared by the builders."""
    e = edges.long()
    return S[e[:, 0], e[:, 1]].float()


def from_edges(S: torch.Tensor, edges: torch.Tensor) -> FilterGraph:
    """FilterGraph from canonical edges and the similarity they filter."""
    w = edge_similarities(S, edges)
    return FilterGraph(edges=edges.to(torch.int32), weights=w,
                       edge_sum=w.sum())
