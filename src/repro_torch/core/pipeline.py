"""End-to-end TMFG-DBHT clustering pipeline in PyTorch (OPT-TDBHT).

The port of ``repro.core.pipeline.cluster`` for the dense TMFG path: the
body of the reference's fused program (``_fused_one``) run eagerly,
stage by stage —

  Pearson similarity (``ops.pearson``, the CUDA kernel on the card)
  → TMFG by ``cfg.method`` (``core/tmfg.py``): lazy, with the top-K
    candidate table for OPT; CORR and ORIG through ``ops.masked_argmax``
  → TMFG edge lengths and APSP (``ops.minplus``, the CUDA kernel)
  → device DBHT: directions, flow, assignment, offsets (``core/dbht.py``)
  → one nested complete linkage (``ops.masked_argmax``, the CUDA kernel)
  → labels, cut on the host.

It runs on CUDA unless the caller passes ``device="cpu"``; with no card
and no ``device="cpu"`` it raises.  ``fused`` keeps the reference's
meaning as far as an eager program has one (DESIGN.md §12.2, §12.4): the
default runs every stage back to back with no sync between them besides
the ones the algorithm needs (one per T captured lazy-TMFG steps, one per
Bellman-Ford round) and one device->host copy at the end; ``fused=False`` synchronises
after each stage and reports per-stage seconds.  Both give bitwise the
same result.

``PipelineConfig.approx()`` (``similarity="topk"``) never builds the
(n, n) similarity: the default runs ``core/fused_approx.py`` (top-K
kernel, sparse TMFG, sparse hub APSP with the relaxation kernel, the
sparse DBHT tail); ``fused=False`` runs the staged form the reference
runs -- the table, the sparse TMFG, the weighted adjacency and the dense
tail above -- and is also where a fused run whose clusters overflow the
reference's slot caps is rerun.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import ops

from repro_torch.approx import knn as knn_mod
from repro_torch.approx import sparse_tmfg as sparse_tmfg_mod

from . import dbht as dbht_mod
from . import fused_approx as fa_mod
from . import hac as hac_mod
from .config import VARIANTS, PipelineConfig, check_ported  # noqa: F401
from .tmfg import (TMFGResult, _build, adjacency_from_weights,
                   prepare_similarity)


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
    the exact path), and for the approx configs ``sim_fallbacks``,
    ``sim_fallback_rate`` and ``sim_pair_misses``.
    """
    cfg = config if config is not None else PipelineConfig()
    check_ported(cfg)
    dev = resolve_device(device)
    fused = True if fused is None else bool(fused)
    if cfg.similarity == "topk":
        return _cluster_approx(X, S, k, cfg, fused, dev, collect_timings)
    t0 = time.perf_counter()
    st = _Stages(dev, fenced=not fused)

    if S is not None:
        S = _as_f32(S, dev)
    elif X is not None:
        S = ops.pearson(_as_f32(X, dev), backend=cfg.backend)
    else:
        raise ValueError("need X or S")
    st.done("similarity")

    tm, syncs = _build(prepare_similarity(S), cfg.method, cfg.prefix,
                       cfg.topk, cfg.backend)
    st.done("tmfg")

    core, rounds = dbht_mod.dense_tail(S, tm, cfg, done=st.done)
    out = _finish(dbht_mod._result_from_device(core), tm, k)
    if collect_timings:
        out.timings = _timings(st, t0, tm, syncs, rounds)
    return out


def _timings(st: _Stages, t0: float, tm: TMFGResult, syncs: int,
             rounds: int) -> Dict[str, float]:
    """Per-stage seconds (staged runs), ``total`` and the loop counts."""
    timings = dict(st.seconds)
    timings["total"] = (sum(st.seconds.values()) if st.fenced
                        else time.perf_counter() - t0)
    timings["tmfg_pops"] = float(tm.pops)
    timings["tmfg_host_syncs"] = float(syncs)
    timings["apsp_rounds"] = float(rounds)
    return timings


def _finish(res: dbht_mod.DBHTResult, tm: TMFGResult,
            k: Optional[int]) -> ClusterResult:
    """The result with the linkage on the host (the one bulk transfer,
    which waits for the device) and the labels cut there."""
    n = res.cluster_of.shape[0]
    linkage = res.linkage.cpu().numpy()          # the one bulk transfer
    kk = k if k is not None else int(res.converging.shape[0])
    labels = hac_mod.cut_linkage(linkage, n, kk)
    return ClusterResult(labels=labels, linkage=linkage, tmfg=tm, dbht=res,
                         edge_sum=float(tm.edge_sum))


def _cluster_approx(X, S, k, cfg: PipelineConfig, fused: bool,
                    dev: torch.device, collect_timings: bool):
    """``similarity="topk"``: the fused body of ``core/fused_approx.py``,
    or, with ``fused=False`` (and after a fused run that overflowed the
    slot caps, as the reference does), the staged path -- the table, the
    sparse TMFG, the weighted adjacency and the dense tail."""
    if S is None and X is None:
        raise ValueError("need X or S")
    have_S = S is not None
    arr = _as_f32(S if have_S else X, dev)
    n = arr.shape[0]
    t0 = time.perf_counter()
    if fused:
        core = fa_mod.fused_one(cfg, have_S, n)(arr)
        if core["overflow"]:
            return _cluster_approx(X, S, k, cfg, False, dev,
                                   collect_timings)
        tm = core["tmfg"]
        res = dbht_mod._result_from_device(core)
        res.hubs = core["hubs"]
        out = _finish(res, tm, k)
        if collect_timings:
            out.timings = _timings(_Stages(dev, fenced=False), t0, tm,
                                   core["tmfg_host_syncs"], core["bf_rounds"])
            out.timings.update(_sim_counts(core["counters"]))
        return out

    st = _Stages(dev, fenced=True)
    kk = min(cfg.sim_k, n - 1)
    if have_S:
        S, Zn = arr, None
        table = knn_mod.topk_from_similarity(S, kk)
    else:
        table, Zn = knn_mod.topk_pearson_and_z(arr, kk, backend=cfg.backend)
    st.done("similarity")
    sst = {}
    tm, w_edges, counters = sparse_tmfg_mod.build_tmfg_sparse(
        table, Xn=Zn, S=S, stats=sst)
    del table, Zn
    if S is None:
        S = adjacency_from_weights(n, tm.edges, w_edges)
    st.done("tmfg")
    core, rounds = dbht_mod.dense_tail(S, tm, cfg, done=st.done)
    out = _finish(dbht_mod._result_from_device(core), tm, k)
    if collect_timings:
        out.timings = _timings(st, t0, tm, sst["host_syncs"], rounds)
        out.timings.update(_sim_counts(counters))
    return out


def _sim_counts(counters) -> Dict[str, float]:
    """The sparse construction's diagnostics, as the reference reports
    them in ``timings``."""
    return {"sim_fallbacks": float(counters.fallbacks),
            "sim_fallback_rate": counters.fallbacks / max(counters.lookups, 1),
            "sim_pair_misses": float(counters.pair_misses)}
