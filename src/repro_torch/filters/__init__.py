"""Pluggable filter-graph front-ends (DESIGN.md §18): the port of
``repro.filters``.

The filter matrix reduces one (n, n) similarity matrix to a sparse graph
that feeds one shared hierarchy tail (``tail.py``):

  ``tmfg``   3n-6 edges, the device insertion loop (``core/tmfg.py``;
             the only filter with the bubble tree DBHT proper needs)
  ``mst``    n-1 edges, device Borůvka rounds (``mst.py``)
  ``pmfg``   3n-6 edges, host planarity-checked greedy insertion
             (``pmfg.py``; needs networkx, staged only)
  ``ag``     the global top-m threshold (``ag.py``)

plus ``rmt.py``, Marchenko–Pastur eigenvalue clipping after the Pearson
stage.  Selected by ``PipelineConfig(filter=..., clean=...)``; MST and
AG run fused and staged in ``cluster`` and ``cluster_batch``.
"""

from __future__ import annotations

from . import rmt  # noqa: F401
from .ag import ag_edge_count, build_ag
from .graph import FilterGraph, from_edges
from .mst import build_mst
from .pmfg import build_pmfg
from .quality import (FILTERS, compare_filters, edge_recall, edge_set,
                      edge_sum_ratio)
from .tail import filter_tail

__all__ = [
    "FilterGraph", "FILTERS", "ag_edge_count", "build_ag", "build_filter",
    "build_mst", "build_pmfg", "compare_filters", "edge_recall", "edge_set",
    "edge_sum_ratio", "filter_tail", "from_edges", "rmt",
]


def build_filter(S, config, *, stats: dict = None) -> FilterGraph:
    """Build ``config.filter``'s graph over a similarity matrix — the
    dispatch the pipeline's fused and staged branches share.
    ``filter="tmfg"`` is not served here: the TMFG keeps its richer
    ``TMFGResult`` through ``tmfg.build_tmfg``.  ``stats``, if a dict,
    receives the MST's ``mst_rounds``."""
    name = config.filter
    if name == "mst":
        return build_mst(S, backend=config.backend, stats=stats)
    if name == "ag":
        return build_ag(S, m=ag_edge_count(int(S.shape[-1]), config.ag_m))
    if name == "pmfg":
        return build_pmfg(S, backend=config.backend)
    raise ValueError(
        f"build_filter serves the non-TMFG filters {('mst', 'pmfg', 'ag')}; "
        f"got filter={name!r} (use tmfg.build_tmfg for the TMFG)")
