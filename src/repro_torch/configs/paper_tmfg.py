"""The paper's own workload: TMFG-DBHT clustering configs (Table 1 sizes)."""

from dataclasses import dataclass


@dataclass(frozen=True)
class TMFGConfig:
    name: str = "paper-tmfg"
    n: int = 19_412           # Crop, the paper's largest dataset
    L: int = 46
    classes: int = 24
    method: str = "lazy"      # OPT-TDBHT path
    topk: int = 64
    apsp_method: str = "hub"
    n_hubs: int = 0           # 0 -> ceil(sqrt(n))
    apsp_rounds: int = 32


CONFIG = TMFGConfig()
