"""The clustering pipeline in PyTorch: the port of ``repro.core`` as far
as the port goes (every paper variant of ``VARIANTS`` on the dense path,
the approx path, ``PipelineConfig.approx()``, and the sparse APSP tail,
``apsp_method="sparse"``, fused in ``fused_approx`` and staged in
``sparse_dbht``; the host DBHT oracle; the batch entry points).

Public API (the reference's names):
  PipelineConfig        -- frozen, hashable stage config (module: .config)
  build_tmfg            -- lazy, CORR and ORIG TMFG builders,
                           device loops                    (module: .tmfg)
  tmfg_ref              -- the numpy TMFG oracles (a copy of the reference's)
  run_dbht              -- DBHT on a TMFG, device or host   (module: .dbht)
  dbht_batch            -- DBHT over a batch of matrices    (module: .dbht)
  dbht_sparse           -- the edge-list DBHT tail   (module: .sparse_dbht)
  apsp_exact / apsp_hub -- all-pairs shortest paths         (module: .apsp)
  complete_linkage      -- complete-linkage HAC             (module: .hac)
  cluster               -- end-to-end pipeline (OPT-TDBHT by default)
  cluster_batch         -- the pipeline over a batch   (BatchClusterResult)
  run_pipeline_device   -- the fused pipeline, outputs left on the device
                           (DeviceOutputs)
  clear_compiled        -- drop every cached program     (module: .jitcache)
  ConfigFields          -- kwarg-era accessors over ``self.cfg`` (.config)
  adjusted_rand_index   -- ARI metric                       (module: .ari)
"""

from . import (apsp, ari, config, dbht, hac, jitcache,  # noqa: F401
               pipeline, sparse_dbht, tmfg, tmfg_ref)
from .apsp import apsp_exact, apsp_hub, edge_lengths  # noqa: F401
from .ari import ari as adjusted_rand_index  # noqa: F401
from .config import ConfigFields, PipelineConfig, VARIANTS  # noqa: F401
from .dbht import DBHTResult, dbht as run_dbht, dbht_batch  # noqa: F401
from .hac import complete_linkage, cut_linkage  # noqa: F401
from .pipeline import (BatchClusterResult, ClusterResult,  # noqa: F401
                       DeviceOutputs, clear_compiled, cluster, cluster_batch,
                       resolve_variant, run_pipeline_device)
from .sparse_dbht import dbht_sparse  # noqa: F401
from .tmfg import TMFGResult, build_tmfg, tmfg_adjacency  # noqa: F401

# restore submodule attributes clobbered by same-named function imports
import sys as _sys
apsp = _sys.modules[__name__ + ".apsp"]
ari = _sys.modules[__name__ + ".ari"]
dbht = _sys.modules[__name__ + ".dbht"]
