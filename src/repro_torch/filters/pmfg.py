"""PMFG — greedy planarity-checked edge insertion (DESIGN.md §18.3).

The port of ``repro.filters.pmfg``.  The Planar Maximally Filtered Graph
inserts edges in descending similarity order, keeping each one only if
the graph stays planar, until it holds 3n-6 edges.  Incremental
planarity testing is sequential and pointer-heavy, so this builder is
the host-orchestrated reference of the filter matrix: the pair order is
a stable descending sort on the device, and the insertion loop runs on
the host against ``networkx.check_planarity``.  ``networkx`` is imported
inside :func:`build_pmfg` (ImportError where it is missing) and no other
filter needs it.  It has no fused form: ``cluster()`` runs it staged.
"""

from __future__ import annotations

import numpy as np
import torch

from .graph import FilterGraph, from_edges


def build_pmfg(S: torch.Tensor, *, backend: str = "auto") -> FilterGraph:
    """PMFG of a symmetric similarity matrix: exactly 3n-6 canonical
    edges (n >= 3), sorted by (i, j).  Weight ties resolve by ascending
    flat pair index (a stable sort); ``backend`` is accepted for the
    reference's signature."""
    import networkx as nx

    S = S.float()
    n = int(S.shape[0])
    if n < 3:
        raise ValueError(f"PMFG needs n >= 3 vertices, got n={n}")
    iu, ju = torch.triu_indices(n, n, 1, device=S.device)
    order = torch.sort(-S[iu, ju], stable=True).indices.cpu().numpy()
    iu_h, ju_h = iu.cpu().numpy(), ju.cpu().numpy()

    target = 3 * n - 6
    G = nx.Graph()
    G.add_nodes_from(range(n))
    picked = []
    for idx in order:
        u, v = int(iu_h[idx]), int(ju_h[idx])
        G.add_edge(u, v)
        planar, _ = nx.check_planarity(G)
        if planar:
            picked.append((u, v))
            if len(picked) == target:
                break
        else:
            G.remove_edge(u, v)
    picked.sort()
    edges = torch.from_numpy(np.asarray(picked, np.int32).reshape(-1, 2))
    return from_edges(S, edges.to(S.device))
