"""End-to-end TMFG-DBHT clustering pipeline in PyTorch (OPT-TDBHT).

The port of ``repro.core.pipeline.cluster`` for the dense TMFG path: the
body of the reference's fused program (``_fused_one``) run eagerly,
stage by stage —

  Pearson similarity (``ops.pearson``, the CUDA kernel on the card)
  → lazy TMFG, with the top-K candidate table for OPT (``core/tmfg.py``)
  → TMFG edge lengths and APSP (``ops.minplus``, the CUDA kernel)
  → device DBHT: directions, flow, assignment, offsets (``core/dbht.py``)
  → one nested complete linkage (``ops.masked_argmax``, the CUDA kernel)
  → labels, cut on the host.

It runs on CUDA unless the caller passes ``device="cpu"``; with no card
and no ``device="cpu"`` it raises.  ``fused`` keeps the reference's
meaning as far as an eager program has one (DESIGN.md §12.2, §12.4): the
default runs every stage back to back with no sync between them besides
the ones the algorithm needs (one per lazy-TMFG pop, one per Bellman-Ford
round) and one device->host copy at the end; ``fused=False`` synchronises
after each stage and reports per-stage seconds.  Both give bitwise the
same result.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import ops

from . import apsp as apsp_mod
from . import dbht as dbht_mod
from . import hac as hac_mod
from .config import VARIANTS, PipelineConfig, check_ported  # noqa: F401
from .tmfg import TMFGResult, _build_lazy, prepare_similarity


@dataclass
class ClusterResult:
    labels: np.ndarray                 # (n,) flat cluster ids (host)
    linkage: np.ndarray                # (n-1, 4) f32 dendrogram (host copy)
    tmfg: TMFGResult                   # tensors on the run's device
    dbht: dbht_mod.DBHTResult          # tensors on the run's device
    edge_sum: float
    timings: Dict[str, float] = field(default_factory=dict)

    def labels_at(self, k: int) -> np.ndarray:
        return self.dbht.labels(k)


def resolve_device(device=None) -> torch.device:
    """CUDA unless ``device`` says otherwise; raise if CUDA is missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def _as_f32(a, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dev, torch.float32)
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def similarity_from_timeseries(X, *, backend: str = "auto",
                               device=None) -> torch.Tensor:
    """Pearson correlation similarity matrix from row time series."""
    return ops.pearson(_as_f32(X, resolve_device(device)), backend=backend)


class _Stages:
    """Per-stage wall clock, fenced by a device sync when ``fenced``."""

    def __init__(self, dev: torch.device, fenced: bool):
        self.dev, self.fenced = dev, fenced
        self.seconds: Dict[str, float] = {}
        self._t = time.perf_counter()

    def done(self, name: str) -> None:
        if not self.fenced:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now


def cluster(X=None, *, S=None, k: Optional[int] = None,
            config: Optional[PipelineConfig] = None,
            fused: Optional[bool] = None, device=None,
            collect_timings: bool = False) -> ClusterResult:
    """Cluster time series X (n, L) — or a precomputed similarity S — with
    TMFG-DBHT.  ``k`` cuts the dendrogram into k flat clusters (default:
    the number of converging bubbles).

    ``config`` selects the stages (default ``PipelineConfig()``, the
    paper's OPT-TDBHT); values this slice has not ported raise
    NotImplementedError.  ``device`` defaults to CUDA.  With
    ``collect_timings`` the result's ``timings`` hold ``total`` seconds
    (and, with ``fused=False``, ``similarity``, ``tmfg``, ``apsp``,
    ``dbht`` and ``hac``), plus the counts ``tmfg_pops``,
    ``tmfg_host_syncs`` and ``apsp_rounds`` (Bellman-Ford rounds; 0 on
    the exact path).
    """
    cfg = config if config is not None else PipelineConfig()
    check_ported(cfg)
    dev = resolve_device(device)
    fused = True if fused is None else bool(fused)
    t0 = time.perf_counter()
    st = _Stages(dev, fenced=not fused)

    if S is not None:
        S = _as_f32(S, dev)
    elif X is not None:
        S = ops.pearson(_as_f32(X, dev), backend=cfg.backend)
    else:
        raise ValueError("need X or S")
    st.done("similarity")

    tm, syncs = _build_lazy(prepare_similarity(S), cfg.topk)
    st.done("tmfg")

    W = apsp_mod.edge_lengths(S.shape[0], tm.edges, S)
    apsp_stats = {"bf_rounds": 0}
    D = apsp_mod.apsp(W, method=cfg.apsp_method, n_hubs=cfg.apsp_hubs,
                      rounds=cfg.apsp_rounds, backend=cfg.backend,
                      stats=apsp_stats)
    del W
    st.done("apsp")

    out = dbht_mod._dbht_tree(S, tm.edges, tm.bubble_parent, tm.bubble_tri,
                              tm.bubble_verts, tm.home_bubble, D)
    st.done("dbht")
    out["Z"] = hac_mod.complete_linkage(out.pop("adj"),
                                                 backend=cfg.backend)
    out["D"] = D
    st.done("hac")

    res = dbht_mod._result_from_device(out)
    linkage = res.linkage.cpu().numpy()          # the one bulk transfer
    kk = k if k is not None else int(res.converging.shape[0])
    labels = hac_mod.cut_linkage(linkage, S.shape[0], kk)
    timings: Dict[str, float] = {}
    if collect_timings:
        timings.update(st.seconds)
        timings["total"] = (sum(st.seconds.values()) if not fused
                            else time.perf_counter() - t0)
        timings["tmfg_pops"] = float(tm.pops)
        timings["tmfg_host_syncs"] = float(syncs)
        timings["apsp_rounds"] = float(apsp_stats["bf_rounds"])
    return ClusterResult(labels=labels, linkage=linkage, tmfg=tm, dbht=res,
                         edge_sum=float(tm.edge_sum), timings=timings)
