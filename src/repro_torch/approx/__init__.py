"""Sparse-similarity clustering that never holds the (n, n) matrix.

The port of ``repro.approx`` (DESIGN.md §13):

  * project.py     -- seeded random-projection sketches → candidate pools
                      (the FLOPs lever, §13.1)
  * knn.py         -- top-K Pearson tables from the series (the streaming
                      ``csrc/topk.cu`` kernel through ``ops.topk``), cut
                      from a dense S, or rescored from pools (§13.2)
  * sparse_tmfg.py -- the lazy TMFG on the (n, K) table with the
                      dense-row fallback and its counters (§13.3)
  * quality.py     -- edge recall / edge-sum ratio / ARI against the
                      dense path (§13.4)

Pipeline entry: ``cluster(X, config=PipelineConfig.approx(sim_k=K))``.
"""

from .knn import (TopKTable, densify, rescore_pools,  # noqa: F401
                  topk_from_similarity, topk_pearson, topk_pearson_and_z)
from .project import candidate_pools, projection, sketch  # noqa: F401
from .sparse_tmfg import (SparseCounters, build_tmfg_sparse,  # noqa: F401
                          sparse_lazy_tmfg)
from .quality import compare_to_dense, edge_recall, edge_sum_ratio  # noqa: F401,E501
