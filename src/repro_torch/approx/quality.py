"""Approximation-quality harness: approx against the dense path
(DESIGN.md §13.4).

The port of ``repro.approx.quality``: TMFG edge recall, the edge-sum
ratio and the ARI of the two flat clusterings, all against the dense
pipeline on the same data, plus the approx run's fallback counters.
The edge-set helpers live in ``repro_torch.filters.quality`` and are
re-exported here, as in the reference.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core.ari import ari
from repro_torch.core.config import PipelineConfig
from repro_torch.filters.quality import (edge_recall, edge_set,  # noqa: F401
                                         edge_sum_ratio)


def compare_to_dense(X, *, sim_k: int, k: Optional[int] = None,
                     config: Optional[PipelineConfig] = None, device=None
                     ) -> Dict[str, float]:
    """Run the topk and dense pipelines on ``X`` (on ``device``, default
    CUDA) and score the approx.

    ``config`` supplies the non-similarity knobs (default OPT); the dense
    run uses it as is, the approx run its ``.replace(similarity="topk",
    sim_k=sim_k)``.  Returns ``ari``, ``edge_recall``, ``edge_sum_ratio``
    and the fallback counters the approx run reported in its timings.
    """
    from repro_torch.core.pipeline import cluster  # lazy: no import cycle

    base = config if config is not None else PipelineConfig.opt()
    dense = cluster(X, k=k, config=base, collect_timings=True, device=device)
    approx = cluster(X, k=k,
                     config=base.replace(similarity="topk", sim_k=sim_k),
                     collect_timings=True, device=device)
    out = dict(
        ari=ari(dense.labels, approx.labels),
        edge_recall=edge_recall(approx.tmfg.edges, dense.tmfg.edges),
        edge_sum_ratio=edge_sum_ratio(approx.edge_sum, dense.edge_sum),
    )
    for key in ("sim_fallbacks", "sim_fallback_rate", "sim_pair_misses"):
        if key in approx.timings:
            out[key] = approx.timings[key]
    return out
