"""Cross-filter quality harness (DESIGN.md §18.5).

The port of ``repro.filters.quality``: the same scale-free metrics — ARI
agreement, edge recall, edge-sum ratio — for every filter on one
dataset, against ground-truth labels when given and against the TMFG
run as the common reference topology.  ``approx/quality.py``
re-exports the edge-set helpers, as in the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

FILTERS = ("tmfg", "mst", "pmfg", "ag")


def edge_set(edges) -> set:
    """Undirected edge set as (min, max) pairs; ``edges`` is an array or
    a tensor on any device."""
    if isinstance(edges, torch.Tensor):
        edges = edges.cpu()
    e = np.asarray(edges)
    return {(int(min(a, b)), int(max(a, b))) for a, b in e}


def edge_recall(edges_a, edges_ref) -> float:
    """|E_a ∩ E_ref| / |E_ref| — overlap with a reference filter."""
    ea, er = edge_set(edges_a), edge_set(edges_ref)
    return len(ea & er) / max(len(er), 1)


def edge_sum_ratio(edge_sum_a: float, edge_sum_ref: float) -> float:
    """Total-similarity-captured ratio against a reference filter."""
    return float(edge_sum_a) / float(edge_sum_ref)


def compare_filters(X, labels=None, *, k: Optional[int] = None,
                    config: Optional["PipelineConfig"] = None,
                    filters: Sequence[str] = FILTERS, device=None
                    ) -> Dict[str, Dict[str, float]]:
    """Cluster ``X`` once per filter and score each run.

    ``config`` supplies the non-filter knobs (default OPT); each run
    uses ``config.replace(filter=f)`` on ``device`` (default CUDA).
    Returns ``{filter: row}`` where every row carries ``edge_sum`` and
    ``n_edges``, plus ``ari`` against ``labels`` when given, and —
    whenever ``"tmfg"`` is in ``filters`` — ``ari_vs_tmfg``,
    ``edge_recall_vs_tmfg`` and ``edge_sum_ratio`` against the TMFG run.
    """
    # lazy: the core package imports the approx one, which re-exports
    # this module's helpers
    from repro_torch.core.ari import ari
    from repro_torch.core.config import PipelineConfig
    from repro_torch.core.pipeline import cluster

    base = config if config is not None else PipelineConfig.opt()
    runs = {f: cluster(X, k=k, config=base.replace(filter=f), device=device)
            for f in filters}
    tm = runs.get("tmfg")
    out: Dict[str, Dict[str, float]] = {}
    for f, res in runs.items():
        row = dict(edge_sum=float(res.edge_sum),
                   n_edges=int(res.tmfg.edges.shape[0]))
        if labels is not None:
            row["ari"] = float(ari(np.asarray(labels), res.labels))
        if tm is not None:
            row["ari_vs_tmfg"] = float(ari(tm.labels, res.labels))
            row["edge_recall_vs_tmfg"] = edge_recall(res.tmfg.edges,
                                                     tm.tmfg.edges)
            row["edge_sum_ratio"] = edge_sum_ratio(res.edge_sum,
                                                   tm.edge_sum)
        out[f] = row
    return out
