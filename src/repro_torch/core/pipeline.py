"""End-to-end TMFG-DBHT clustering pipeline in PyTorch (OPT-TDBHT).

The port of ``repro.core.pipeline``: :func:`cluster` for one matrix and
:func:`cluster_batch` for a batch.  The dense path runs the body of the
reference's fused program (``_fused_one``) eagerly, stage by stage --

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
Bellman-Ford round) and one device->host copy at the end;
``fused=False`` synchronises after each stage and reports per-stage
seconds.  Both give bitwise the same result.

``PipelineConfig.approx()`` (``similarity="topk"``) and
``apsp_method="sparse"`` run, by default, the body of
``core/fused_approx.py`` (the top-K kernel or the dense S, the TMFG, the
sparse hub APSP with the relaxation kernel, the sparse DBHT tail, which
never forms (n, n)).  ``fused=False`` runs the staged form the reference
runs -- the table (or S), the TMFG, then ``dbht.run_dbht``: the sparse
tail of ``core/sparse_dbht.py`` or the dense tail -- and is where a fused
run whose clusters overflow the reference's slot caps is rerun, and the
only path for ``dbht_impl="host"`` (the numpy oracle) and
``reuse_tmfg=``.

``clean="rmt"`` (DESIGN.md §18.2) cleans S by eigenvalue clipping
(``filters/rmt.py``) after the Pearson stage, on every filter.  A
non-TMFG ``filter`` (§18) runs, fused and staged, the similarity (and
the cleaning), the filter's builder (``filters.build_filter``: the MST's
Borůvka rounds, the AG's top-m, the PMFG's host loop, staged only) and
the edge-list tail (``filters.filter_tail``: APSP on the filter's edges
by ``apsp_method``, components, one nested complete linkage) in place of
the TMFG and DBHT stages.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import ops

from repro_torch.approx import knn as knn_mod
from repro_torch.approx import sparse_tmfg as sparse_tmfg_mod

from . import dbht as dbht_mod
from . import fused_approx as fa_mod
from . import hac as hac_mod
from .config import VARIANTS, PipelineConfig  # noqa: F401
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
    # True when the TMFG was carried over (cluster(reuse_tmfg=...)) rather
    # than built on this similarity
    reused_tmfg: bool = False

    def labels_at(self, k: int) -> np.ndarray:
        return self.dbht.labels(k)


@dataclass
class BatchClusterResult:
    """Results for a batch: ``labels`` stacks the flat assignments
    (B_out, n); ``results`` holds each entry's :class:`ClusterResult`."""

    labels: np.ndarray                     # (B_out, n)
    results: List[ClusterResult]
    timings: Dict[str, float] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.results)

    def __getitem__(self, b: int) -> ClusterResult:
        return self.results[b]

    def __iter__(self):
        return iter(self.results)


def resolve_variant(variant: Optional[str], *, method: str = "lazy",
                    prefix: int = 10, topk: int = 64,
                    apsp_method: str = "hub"):
    """The kwarg-era shim: (method, prefix, topk, apsp_method) for a named
    variant, or the values given when ``variant`` is None, through
    :meth:`PipelineConfig.resolve`."""
    cfg = PipelineConfig.resolve(variant, method=method, prefix=prefix,
                                 topk=topk, apsp_method=apsp_method)
    return cfg.method, cfg.prefix, cfg.topk, cfg.apsp_method


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
    """Per-stage wall clock, fenced by a device sync when ``fenced``.

    With ``events`` an unfenced run on the card records a CUDA event at
    each stage's end instead (no sync), and :meth:`read` turns them into
    the seconds between them once the last has completed; on the CPU an
    unfenced run with ``events`` takes the wall clock (its operations are
    synchronous)."""

    def __init__(self, dev: torch.device, fenced: bool,
                 events: bool = False):
        self.dev, self.fenced = dev, fenced
        self.timed = fenced or events
        self.seconds: Dict[str, float] = {}
        self._t = time.perf_counter()
        self._marks = None
        if events and not fenced and dev.type == "cuda":
            self._marks = [("", self._event())]

    @staticmethod
    def _event() -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def done(self, name: str) -> None:
        if self._marks is not None:
            self._marks.append((name, self._event()))
            return
        if not self.timed:
            return
        if self.fenced and self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now

    def read(self) -> Dict[str, float]:
        """The stage seconds (waiting for the last event, if any)."""
        if self._marks is not None:
            self._marks[-1][1].synchronize()
            for (_, a), (name, b) in zip(self._marks, self._marks[1:]):
                self.seconds[name] = a.elapsed_time(b) / 1e3
            self._marks = None
        return self.seconds


def _needs_approx_body(cfg: PipelineConfig) -> bool:
    """Configs whose fused form is ``core/fused_approx.py``'s body (the
    reference's rule).  Non-TMFG filters never route here: their sparse
    APSP runs inside the §18.4 tail on the filter's own edge list."""
    return cfg.filter == "tmfg" and (cfg.similarity == "topk"
                                     or cfg.apsp_method == "sparse")


def _setup(cfg: PipelineConfig, fused: Optional[bool], can_fuse: bool,
           refusal: str, mesh, moments, device):
    """The checks every entry point makes; returns (fused, device)."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (the multi-device funnel) is not ported to repro_torch "
            "yet; see ROADMAP.md Queue 1 item 14")
    if moments is not None:
        raise NotImplementedError(
            "moments= (streaming window co-moments) is not ported to "
            "repro_torch yet; see ROADMAP.md Queue 1 item 12")
    dev = resolve_device(device)
    if fused is None:
        fused = can_fuse
    elif fused and not can_fuse:
        raise ValueError(refusal)
    return bool(fused), dev


_FUSED_REFUSAL = (
    "fused=True requires dbht_impl='device', no reuse_tmfg and a "
    "device-buildable filter (the staged path is the host-oracle/"
    "warm-start mode and the only path for the host-orchestrated "
    "filter='pmfg', DESIGN.md §18.3; fused=False also remains the "
    "per-stage-timings mode, DESIGN.md §12.4)")
_BATCH_FUSED_REFUSAL = (
    "fused=True requires dbht_impl='device' and a device-buildable "
    "filter (the staged path is the host-oracle mode and the only "
    "path for the host-orchestrated filter='pmfg', DESIGN.md "
    "§18.3; fused=False also remains the per-stage-timings mode, "
    "DESIGN.md §12.4)")
_RMT_REFUSAL = (
    "clean='rmt' needs the raw series X: the Marchenko–Pastur bulk edge "
    "comes from the (n, T) window shape (DESIGN.md §18.2) — pass X, not "
    "S/moments")


def cluster(X=None, *, S=None, moments=None, k: Optional[int] = None,
            config: Optional[PipelineConfig] = None,
            method: Optional[str] = None, prefix: Optional[int] = None,
            topk: Optional[int] = None, apsp_method: Optional[str] = None,
            backend: Optional[str] = None, variant: Optional[str] = None,
            reuse_tmfg=None, dbht_impl: Optional[str] = None,
            fused: Optional[bool] = None, mesh=None, device=None,
            collect_timings: bool = False) -> ClusterResult:
    """Cluster time series X (n, L) — or a precomputed similarity S — with
    TMFG-DBHT.  ``k`` cuts the dendrogram into k flat clusters (default:
    the number of converging bubbles).

    ``config`` selects the stages (default ``PipelineConfig()``, the
    paper's OPT-TDBHT); the loose ``method/prefix/topk/apsp_method/
    backend/variant/dbht_impl`` kwargs resolve through
    :meth:`PipelineConfig.resolve` instead (combining them with
    ``config=`` raises ValueError).  ``mesh=`` and ``moments=`` raise
    NotImplementedError.  ``reuse_tmfg`` (a ``TMFGResult``) skips the
    TMFG construction and reruns only the DBHT stage on it, staged; with
    ``similarity="topk"`` it needs ``S=``.  ``clean="rmt"`` needs X, and
    ``filter="pmfg"`` runs staged only (both raise ValueError otherwise,
    as in the reference).  ``device`` defaults to CUDA.

    With ``collect_timings`` the result's ``timings`` hold ``total``
    seconds (and, with ``fused=False``, ``similarity``, ``tmfg``,
    ``apsp``, ``dbht`` and ``hac``, and ``clean`` after it with
    ``clean="rmt"``), plus the counts ``tmfg_pops``, ``tmfg_host_syncs``
    and ``apsp_rounds`` (Bellman-Ford rounds; 0 on the exact path), and
    for the lazy approx configs ``sim_fallbacks``, ``sim_fallback_rate``
    and ``sim_pair_misses``.  A non-TMFG filter reports the stages in
    both modes (fused: from CUDA events, no sync), "tmfg" timing the
    filter's build and "dbht" its components, and the counts
    ``apsp_rounds`` and, for the MST, ``mst_rounds``.
    """
    cfg = PipelineConfig.resolve(
        variant, config, method=method, prefix=prefix, topk=topk,
        apsp_method=apsp_method, backend=backend, dbht_impl=dbht_impl)
    if cfg.clean == "rmt" and (X is None or S is not None):
        raise ValueError(_RMT_REFUSAL)
    if cfg.filter != "tmfg" and reuse_tmfg is not None:
        raise ValueError(
            f"reuse_tmfg is the TMFG warm-start splice (DESIGN.md §10); "
            f"filter={cfg.filter!r} rebuilds its graph per window")
    fused, dev = _setup(
        cfg, fused, (cfg.dbht_impl == "device" and reuse_tmfg is None
                     and cfg.filter != "pmfg"),
        _FUSED_REFUSAL, mesh, moments, device)
    run = _run_one(X, S, cfg, fused, dev, reuse_tmfg, collect_timings)
    return _finish(run, k)


class _Run(NamedTuple):
    """One entry's outputs before the host copy of its linkage."""

    res: dbht_mod.DBHTResult
    tm: TMFGResult
    timings: Dict[str, float]
    reused: bool


def _run_one(X, S, cfg: PipelineConfig, fused: bool, dev: torch.device,
             reuse_tmfg, collect_timings: bool) -> _Run:
    """One matrix through the fused or the staged pipeline, up to the
    DBHT result on the device."""
    if S is None and X is None:
        raise ValueError("need X or S")
    have_S = S is not None
    arr = _as_f32(S if have_S else X, dev)
    n = arr.shape[0]
    t0 = time.perf_counter()
    if cfg.filter != "tmfg":
        return _run_filter(arr, have_S, cfg, fused, dev, collect_timings)
    if fused and _needs_approx_body(cfg):
        core = fa_mod.fused_one(cfg, have_S, n)(arr)
        if core["overflow"]:
            # the reference's slot caps cannot hold these clusters: the
            # staged path sizes its blocks per cluster, so rerun there
            return _run_one(X, S, cfg, False, dev, None, collect_timings)
        tm = core["tmfg"]
        res = dbht_mod._result_from_device(core)
        res.hubs = core["hubs"]
        timings = {}
        if collect_timings:
            timings = _timings(_Stages(dev, fenced=False), t0,
                               _tmfg_counts(tm, core["tmfg_host_syncs"],
                                            core["bf_rounds"]))
            if core["counters"] is not None:
                timings.update(_sim_counts(core["counters"]))
        return _Run(res, tm, timings, False)

    st = _Stages(dev, fenced=not fused)
    approx = cfg.similarity == "topk"
    if approx and reuse_tmfg is not None and not have_S:
        raise ValueError(
            "similarity='topk' with reuse_tmfg needs S= or moments=: the "
            "warm-start splice reruns DBHT on the window's similarities, "
            "which only exist materialized (DESIGN.md §13)")
    S = arr if have_S else None
    table = Zn = counters = w_edges = None
    if not approx:
        if S is None:
            S = ops.pearson(arr, backend=cfg.backend)
    elif reuse_tmfg is None:
        kk = min(cfg.sim_k, n - 1)
        if have_S:
            table = knn_mod.topk_from_similarity(S, kk)
        else:
            table, Zn = knn_mod.topk_pearson_and_z(arr, kk,
                                                   backend=cfg.backend)
    st.done("similarity")
    if cfg.clean == "rmt":
        S = _clean(S, arr.shape[-1])
        st.done("clean")

    syncs = 0
    if reuse_tmfg is not None:
        tm = type(reuse_tmfg)(*(f.to(dev) for f in reuse_tmfg))
    elif approx and cfg.method == "lazy":
        sst = {}
        tm, w_edges, counters = sparse_tmfg_mod.build_tmfg_sparse(
            table, Xn=Zn, S=S, stats=sst)
        syncs = sst["host_syncs"]
        if S is None and cfg.apsp_method != "sparse":
            # the sparse tail takes w_edges itself; the others gather
            # from the weighted adjacency
            S = adjacency_from_weights(n, tm.edges, w_edges)
    else:
        if approx:
            # non-lazy methods run on the densified table (§13.3)
            S = knn_mod.densify(table, n=n)
        tm, syncs = _build(prepare_similarity(S), cfg.method, cfg.prefix,
                           cfg.topk, cfg.backend)
    del table, Zn
    st.done("tmfg")

    stats = {}
    res = dbht_mod.run_dbht(S, tm, cfg, impl=cfg.dbht_impl,
                            edge_weights=w_edges, done=st.done, stats=stats)
    timings = {}
    if collect_timings:
        timings = _timings(st, t0, _tmfg_counts(
            tm, syncs, stats.get("bf_rounds", 0)))
        if counters is not None:
            timings.update(_sim_counts(counters))
    return _Run(res, tm, timings, reuse_tmfg is not None)


def _clean(S: torch.Tensor, T: int) -> torch.Tensor:
    """The RMT cleaning step (§18.2), shared by every path."""
    from repro_torch.filters import rmt  # lazy: filters imports core
    return rmt.clean(S, T)


def _run_filter(arr: torch.Tensor, have_S: bool, cfg: PipelineConfig,
                fused: bool, dev: torch.device,
                collect_timings: bool) -> _Run:
    """A non-TMFG filter (§18): similarity (and the RMT cleaning), the
    filter's build and the §18.4 edge-list tail, the same calls fused and
    staged (staged syncs after each stage)."""
    from repro_torch import filters as filt  # lazy: filters imports core

    st = _Stages(dev, fenced=not fused, events=collect_timings)
    t0 = time.perf_counter()
    S = arr if have_S else ops.pearson(arr, backend=cfg.backend)
    st.done("similarity")
    if cfg.clean == "rmt":
        S = _clean(S, arr.shape[-1])
        st.done("clean")
    stats = {}
    fg = filt.build_filter(S, cfg, stats=stats)
    st.done("tmfg")
    core = filt.filter_tail(S, fg, apsp_method=cfg.apsp_method,
                            apsp_hubs=cfg.apsp_hubs,
                            apsp_rounds=cfg.apsp_rounds,
                            backend=cfg.backend, done=st.done, stats=stats)
    res = dbht_mod._result_from_device(core)
    timings = {}
    if collect_timings:
        st.read()
        timings = _timings(st, t0, {"apsp_rounds": stats.pop("bf_rounds", 0),
                                    **stats})
    return _Run(res, fg, timings, False)


def _tmfg_counts(tm: TMFGResult, syncs: int, rounds: int) -> Dict[str, int]:
    """The TMFG path's loop counts, as ``timings`` reports them."""
    return {"tmfg_pops": int(tm.pops), "tmfg_host_syncs": syncs,
            "apsp_rounds": rounds}


def _timings(st: _Stages, t0: float,
             counts: Dict[str, int]) -> Dict[str, float]:
    """Per-stage seconds (where timed), ``total`` and the loop counts."""
    timings = dict(st.seconds)
    timings["total"] = (sum(st.seconds.values()) if st.fenced
                        else time.perf_counter() - t0)
    timings.update({key: float(v) for key, v in counts.items()})
    return timings


def _sim_counts(counters) -> Dict[str, float]:
    """The sparse construction's diagnostics, as the reference reports
    them in ``timings``."""
    return {"sim_fallbacks": float(counters.fallbacks),
            "sim_fallback_rate": counters.fallbacks / max(counters.lookups, 1),
            "sim_pair_misses": float(counters.pair_misses)}


def _finish(run: _Run, k: Optional[int],
            linkage: Optional[np.ndarray] = None) -> ClusterResult:
    """The result with the linkage on the host (by default its own copy,
    which waits for the device) and the labels cut there."""
    res = run.res
    n = res.cluster_of.shape[0]
    if linkage is None:
        linkage = res.linkage.cpu().numpy()          # the one bulk transfer
    kk = k if k is not None else int(res.converging.shape[0])
    labels = hac_mod.cut_linkage(linkage, n, kk)
    return ClusterResult(labels=labels, linkage=linkage, tmfg=run.tm,
                         dbht=res, edge_sum=float(run.tm.edge_sum),
                         timings=run.timings, reused_tmfg=run.reused)


def cluster_batch(X=None, *, S=None, k: Optional[int] = None,
                  config: Optional[PipelineConfig] = None,
                  method: Optional[str] = None, prefix: Optional[int] = None,
                  topk: Optional[int] = None,
                  apsp_method: Optional[str] = None,
                  backend: Optional[str] = None,
                  variant: Optional[str] = None, mesh=None,
                  limit: Optional[int] = None,
                  dbht_impl: Optional[str] = None,
                  fused: Optional[bool] = None, device=None,
                  collect_timings: bool = False) -> BatchClusterResult:
    """Cluster a batch of datasets X (B, n, L) — or similarities
    S (B, n, n) — with the stages :func:`cluster` takes (``config`` or
    the loose kwargs, ``fused``, ``device``); entry b is bitwise
    ``cluster(X[b], ...)``, fused and staged.

    The entries run one after another on the device; the linkages of the
    first ``limit`` entries (all by default) come to the host in one
    copy at the end, and only those are cut and returned.  Entries past
    ``limit`` (the pads of a bucketed micro-batch) do device work only.
    Running the batch as one captured program is later performance work
    (ROADMAP Queue 1 item 6).  ``timings`` holds the batch's ``total``
    seconds and, with ``collect_timings``, the other keys of the entries'
    timings summed over the batch (each result keeps its own).
    """
    cfg = PipelineConfig.resolve(
        variant, config, method=method, prefix=prefix, topk=topk,
        apsp_method=apsp_method, backend=backend, dbht_impl=dbht_impl)
    if cfg.clean == "rmt" and (X is None or S is not None):
        raise ValueError(_RMT_REFUSAL)
    fused, dev = _setup(cfg, fused,
                        cfg.dbht_impl == "device" and cfg.filter != "pmfg",
                        _BATCH_FUSED_REFUSAL, mesh, None, device)
    if S is None and X is None:
        raise ValueError("need X or S")
    have_S = S is not None
    arr = _as_f32(S if have_S else X, dev)
    if arr.ndim != 3:
        raise ValueError(f"batched input must be 3-D, got {tuple(arr.shape)}")
    if limit is not None and limit < 1:
        raise ValueError(f"limit must be >= 1, got {limit}")
    B = arr.shape[0]
    B_out = B if limit is None else min(limit, B)
    t0 = time.perf_counter()
    runs = [_run_one(None if have_S else arr[b], arr[b] if have_S else None,
                     cfg, fused, dev, None, collect_timings)
            for b in range(B)]
    Z = torch.stack([r.res.linkage for r in runs[:B_out]]).cpu().numpy()
    results = [_finish(runs[b], k, Z[b]) for b in range(B_out)]
    timings = {}
    if collect_timings:
        for r in runs:
            for key, v in r.timings.items():
                if key != "sim_fallback_rate":
                    timings[key] = timings.get(key, 0.0) + v
    timings["total"] = time.perf_counter() - t0
    return BatchClusterResult(
        labels=np.stack([r.labels for r in results]), results=results,
        timings=timings)
