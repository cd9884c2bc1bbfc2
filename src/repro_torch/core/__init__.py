"""The clustering pipeline in PyTorch: the port of ``repro.core`` as far
as the port goes (every paper variant of ``VARIANTS`` on the dense path,
and the approx path, ``PipelineConfig.approx()``, in ``fused_approx``).

Public API (the reference's names):
  PipelineConfig        -- frozen, hashable stage config (module: .config)
  build_tmfg            -- lazy, CORR and ORIG TMFG builders,
                           device loops                    (module: .tmfg)
  tmfg_ref              -- the numpy TMFG oracles (a copy of the reference's)
  run_dbht              -- device DBHT on a TMFG            (module: .dbht)
  apsp_exact / apsp_hub -- all-pairs shortest paths         (module: .apsp)
  complete_linkage      -- complete-linkage HAC             (module: .hac)
  cluster               -- end-to-end pipeline (OPT-TDBHT by default)
  adjusted_rand_index   -- ARI metric                       (module: .ari)
"""

from . import (apsp, ari, config, dbht, hac, pipeline, tmfg,  # noqa: F401
               tmfg_ref)
from .apsp import apsp_exact, apsp_hub, edge_lengths  # noqa: F401
from .ari import ari as adjusted_rand_index  # noqa: F401
from .config import PipelineConfig, VARIANTS  # noqa: F401
from .dbht import DBHTResult, dbht as run_dbht  # noqa: F401
from .hac import complete_linkage, cut_linkage  # noqa: F401
from .pipeline import ClusterResult, cluster  # noqa: F401
from .tmfg import TMFGResult, build_tmfg, tmfg_adjacency  # noqa: F401

# restore submodule attributes clobbered by same-named function imports
import sys as _sys
apsp = _sys.modules[__name__ + ".apsp"]
ari = _sys.modules[__name__ + ".ari"]
dbht = _sys.modules[__name__ + ".dbht"]
