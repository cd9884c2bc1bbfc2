"""Sparse-similarity clustering that never holds the (n, n) matrix.

The port of ``repro.approx`` (DESIGN.md §13) as far as the approx
pipeline needs it:

  * knn.py        -- top-K Pearson tables from the series (the streaming
                     ``csrc/topk.cu`` kernel through ``ops.topk``) or cut
                     from a dense S
  * sparse_tmfg.py -- the lazy TMFG on the (n, K) table with the
                     dense-row fallback and its counters

Pipeline entry: ``cluster(X, config=PipelineConfig.approx(sim_k=K))``.
``project.py``, ``quality.py`` and ``rescore_pools`` are still to port
(ROADMAP Queue 1 item 7).
"""

from .knn import (TopKTable, densify, topk_from_similarity,  # noqa: F401
                  topk_pearson, topk_pearson_and_z)
from .sparse_tmfg import (SparseCounters, build_tmfg_sparse,  # noqa: F401
                          sparse_lazy_tmfg)
