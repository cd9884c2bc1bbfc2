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

``moments=`` (a ``repro_torch.stream.window.WindowState``) takes S from
the rolling window's co-moments (``window_similarity``) in place of the
Pearson pass, fused and staged.  :func:`run_pipeline_device` runs the
fused form and leaves every output on the device (:class:`DeviceOutputs`).

Observability (DESIGN.md §15): ``pipeline_stage_seconds{stage=}`` and
``pipeline_total_seconds{path=}`` histograms, the ``approx_*_total``
counters, and the spans ``pipeline.fused`` (unfenced: the linkage's
download is its one sync; with tracing on, its ``pipeline.similarity``,
``pipeline.tmfg`` and ``pipeline.dbht+apsp`` children come from CUDA
events, adding no sync) and, staged, the three stage spans, fenced
through ``obs.trace.device_wait``.  The recompile watchdog remembers
every fused (config, input kind, shape, device) it has run; a replay of
one that builds a new loop program (``core/tmfg.LoopProgram``) raises
its alarm (``obs.trace.record_recompile``).  :func:`clear_compiled`
drops every cached program and what the watchdog remembers.

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

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

from repro_torch.approx import knn as knn_mod
from repro_torch.approx import sparse_tmfg as sparse_tmfg_mod

from . import dbht as dbht_mod
from . import fused_approx as fa_mod
from . import hac as hac_mod
from . import jitcache
from . import tmfg as tmfg_mod
from .config import VARIANTS, PipelineConfig  # noqa: F401
from .tmfg import TMFGResult, _build, adjacency_from_weights


def _observe_stage(stage: str, seconds: float) -> None:
    """Per-stage latency into the process-global registry (DESIGN.md
    §15.3), from the staged path's fenced stage clock."""
    obs_metrics.histogram("pipeline_stage_seconds",
                          "staged-path per-stage latency (fenced)",
                          stage=stage).observe(seconds)


def _observe_total(path: str, seconds: float) -> None:
    obs_metrics.histogram("pipeline_total_seconds",
                          "end-to-end cluster()/cluster_batch() latency",
                          path=path).observe(seconds)


def _observe_counters(counters) -> None:
    """The approx construction's lookup counts into the registry."""
    obs_metrics.counter("approx_lookups_total").inc(counters.lookups)
    obs_metrics.counter("approx_fallbacks_total").inc(counters.fallbacks)
    obs_metrics.counter("approx_pair_misses_total").inc(
        counters.pair_misses)


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
    """Per-stage wall clock, fenced by a device sync when ``fenced``
    (through ``obs.trace.device_wait``, the one function that waits).

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
        if self.fenced:
            obs_trace.device_wait(self.dev)
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


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (the multi-device funnel) is not ported to repro_torch "
            "yet; see ROADMAP.md Queue 1 item 14")


def _setup(cfg: PipelineConfig, fused: Optional[bool], can_fuse: bool,
           refusal: str, mesh, device):
    """The checks every entry point makes; returns (fused, device)."""
    _no_mesh(mesh)
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
    """Cluster time series X (n, L) — or a precomputed similarity S, or
    the similarity of a rolling window's co-moments ``moments`` (a
    ``repro_torch.stream.window.WindowState``) — with TMFG-DBHT.  ``k``
    cuts the dendrogram into k flat clusters (default: the number of
    converging bubbles).

    ``config`` selects the stages (default ``PipelineConfig()``, the
    paper's OPT-TDBHT); the loose ``method/prefix/topk/apsp_method/
    backend/variant/dbht_impl`` kwargs resolve through
    :meth:`PipelineConfig.resolve` instead (combining them with
    ``config=`` raises ValueError).  ``mesh=`` raises
    NotImplementedError.  ``reuse_tmfg`` (a ``TMFGResult``) skips the
    TMFG construction and reruns only the DBHT stage on it, staged; with
    ``similarity="topk"`` it needs ``S=`` or ``moments=``.
    ``clean="rmt"`` needs X, and ``filter="pmfg"`` runs staged only
    (both raise ValueError otherwise, as in the reference).  ``device``
    defaults to CUDA.

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
    if cfg.clean == "rmt" and (X is None or S is not None
                               or moments is not None):
        raise ValueError(_RMT_REFUSAL)
    if cfg.filter != "tmfg" and reuse_tmfg is not None:
        raise ValueError(
            f"reuse_tmfg is the TMFG warm-start splice (DESIGN.md §10); "
            f"filter={cfg.filter!r} rebuilds its graph per window")
    fused, dev = _setup(
        cfg, fused, (cfg.dbht_impl == "device" and reuse_tmfg is None
                     and cfg.filter != "pmfg"),
        _FUSED_REFUSAL, mesh, device)
    if S is None and moments is not None:
        from repro_torch.stream.window import window_similarity  # no cycle
        S = window_similarity(moments)
    if S is None and X is None:
        raise ValueError("need X, S or moments")
    have_S = S is not None
    arr = _as_f32(S if have_S else X, dev)
    if not fused:
        run = _run_one(arr, have_S, cfg, False, dev, reuse_tmfg,
                       collect_timings)
        _observe_staged([run])
        return _finish(run, k)
    # fence=False: the linkage's download is the fused path's one sync,
    # and the span adds none (DESIGN.md §15.1)
    with obs_trace.span("pipeline.fused", fence=False) as sp:
        with _watch_replay(cfg, have_S, arr.shape, dev, batched=False):
            run = _run_one(arr, have_S, cfg, True, dev, None,
                           collect_timings)
        out = _finish(run, k)
        _record_fused_stages([run])
    _observe_total("fused", sp.duration)
    if run.counters is not None:
        _observe_counters(run.counters)
    return out


class _Run(NamedTuple):
    """One entry's outputs before the host copy of its linkage."""

    res: dbht_mod.DBHTResult
    tm: TMFGResult
    timings: Dict[str, float]
    reused: bool
    stages: Optional["_Stages"] = None     # the stage clock, for spans
    counters: object = None                # SparseCounters (approx)
    overflow: Optional[bool] = None        # fused approx body: caps hit


_STAGE_SPANS = {"similarity": "similarity", "clean": "similarity",
                "tmfg": "tmfg"}


def _stage_groups(runs) -> Dict[str, float]:
    """The runs' stage seconds in the reference's three spans:
    similarity (and the cleaning), tmfg, and dbht+apsp (APSP, DBHT and
    the HAC)."""
    groups = {"similarity": 0.0, "tmfg": 0.0, "dbht+apsp": 0.0}
    for r in runs:
        if r.stages is None:
            continue
        for name, sec in r.stages.read().items():
            groups[_STAGE_SPANS.get(name, "dbht+apsp")] += sec
    return groups


def _observe_staged(runs) -> None:
    """The staged path's fenced stage spans, the histograms and the
    approx counters of its runs."""
    groups = _stage_groups(runs)
    for name, sec in groups.items():
        obs_trace.record_span(f"pipeline.{name}", sec, fenced=True,
                              batch=len(runs))
        _observe_stage(name, sec)
    _observe_total("staged", sum(groups.values()))
    for r in runs:
        if r.counters is not None:
            _observe_counters(r.counters)


def _record_fused_stages(runs) -> None:
    """With tracing on, the fused runs' stage spans (children of the
    open ``pipeline.fused`` span) from their CUDA events, read after the
    download has waited for them: no sync is added."""
    if not obs_trace.enabled():
        return
    for name, sec in _stage_groups(runs).items():
        obs_trace.record_span(f"pipeline.{name}", sec, fenced=False,
                              batch=len(runs))


# the fused (config, input kind, shape, device) keys the watchdog has seen
_seen_fused: set = set()


@contextlib.contextmanager
def _watch_replay(cfg: PipelineConfig, have_S: bool, shape, dev,
                  batched: bool):
    """The recompile watchdog around one fused call (DESIGN.md §15.2): a
    replay of a (config, input kind, shape, device) key it has seen that
    builds a loop program anyway raises ``obs.trace.record_recompile``."""
    key = ("fused", cfg, have_S, batched, tuple(shape),
           str(tmfg_mod.program_device(dev)))
    replay = key in _seen_fused
    _seen_fused.add(key)
    before = obs_trace.compile_stats()["programs"]
    yield
    if replay and obs_trace.compile_stats()["programs"] > before:
        obs_trace.record_recompile(
            detail="replayed fused call built a new loop program",
            shape=str(tuple(shape)), batched=batched)


def _run_one(arr: torch.Tensor, have_S: bool, cfg: PipelineConfig,
             fused: bool, dev: torch.device, reuse_tmfg,
             collect_timings: bool) -> _Run:
    """One matrix (X, or S when ``have_S``, float32 on ``dev``) through
    the fused or the staged pipeline, up to the DBHT result on the
    device."""
    n = arr.shape[0]
    t0 = time.perf_counter()
    if cfg.filter != "tmfg":
        return _run_filter(arr, have_S, cfg, fused, dev, collect_timings)
    if fused and _needs_approx_body(cfg):
        core = fa_mod.fused_one(cfg, have_S, n)(arr)
        if core["overflow"]:
            # the reference's slot caps cannot hold these clusters: the
            # staged path sizes its blocks per cluster, so rerun there
            return _run_one(arr, have_S, cfg, False, dev, None,
                            collect_timings)._replace(overflow=True)
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
        return _Run(res, tm, timings, False, counters=core["counters"],
                    overflow=False)

    approx = cfg.similarity == "topk"
    if approx and reuse_tmfg is not None and not have_S:
        raise ValueError(
            "similarity='topk' with reuse_tmfg needs S= or moments=: the "
            "warm-start splice reruns DBHT on the window's similarities, "
            "which only exist materialized (DESIGN.md §13)")
    with contextlib.ExitStack() as hold:
        st = _Stages(dev, fenced=not fused, events=obs_trace.enabled())
        S = arr if have_S else None
        table = Zn = counters = w_edges = prog = None
        if not approx:
            if S is None and (cfg.method == "lazy" and cfg.clean == "none"
                              and reuse_tmfg is None):
                # the Pearson kernel writes S straight into the cached
                # lazy program's S buffer, which the TMFG builds on and
                # the DBHT stage reads: the program is held until then
                prog = tmfg_mod.dense_program(
                    n, tmfg_mod.table_width(cfg.topk, n), dev)
                hold.enter_context(prog.lock)
                S = ops.pearson(arr, backend=cfg.backend, out=prog.d.S)
            elif S is None:
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
        elif prog is not None:
            tm, syncs = tmfg_mod.build_dense(prog)
        else:
            if approx:
                # non-lazy methods run on the densified table (§13.3)
                S = knn_mod.densify(table, n=n)
            tm, syncs = _build(S, cfg.method, cfg.prefix, cfg.topk,
                                  cfg.backend)
        del table, Zn
        st.done("tmfg")

        stats = {}
        res = dbht_mod.run_dbht(S, tm, cfg, impl=cfg.dbht_impl,
                                edge_weights=w_edges, done=st.done,
                                stats=stats)
    timings = {}
    if collect_timings:
        timings = _timings(st, t0, _tmfg_counts(
            tm, syncs, stats.get("bf_rounds", 0)), stages=not fused)
        if counters is not None:
            timings.update(_sim_counts(counters))
    return _Run(res, tm, timings, reuse_tmfg is not None,
                stages=st if st.timed else None, counters=counters)


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

    st = _Stages(dev, fenced=not fused,
                 events=collect_timings or obs_trace.enabled())
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
    return _Run(res, fg, timings, False, stages=st if st.timed else None)


def _tmfg_counts(tm: TMFGResult, syncs: int, rounds: int) -> Dict[str, int]:
    """The TMFG path's loop counts, as ``timings`` reports them."""
    return {"tmfg_pops": int(tm.pops), "tmfg_host_syncs": syncs,
            "apsp_rounds": rounds}


def _timings(st: _Stages, t0: float, counts: Dict[str, int],
             stages: bool = True) -> Dict[str, float]:
    """Per-stage seconds (where timed, and ``stages``), ``total`` and the
    loop counts."""
    timings = dict(st.seconds) if stages else {}
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


# ---------------------------------------------------------------------------
# the fused program's outputs, left on the device (DESIGN.md §12.2)
# ---------------------------------------------------------------------------

class DeviceOutputs(NamedTuple):
    """Everything the fused pipeline leaves on the device: the TMFG (or
    filter graph) tensors plus the DBHT stage outputs, the reference's
    fields.  Batched runs carry a leading batch axis on every tensor.

    ``direction`` and ``conv_mask`` have one entry per bubble (entry 0,
    the root's direction, unused); ``apsp`` is the (n, n) distances or,
    on the sparse tail, the (h, n) hub factor.  The last three fields
    exist only on the approx/sparse body: ``hubs``, ``overflow`` (a bool
    tensor: the reference's slot caps were exceeded, and the outputs
    come from the staged rerun) and ``counters`` (SparseCounters)."""

    tmfg: object
    direction: torch.Tensor
    conv_mask: torch.Tensor
    cluster_of: torch.Tensor
    bubble_of: torch.Tensor
    apsp: torch.Tensor
    linkage: torch.Tensor
    hubs: Optional[torch.Tensor] = None
    overflow: Optional[torch.Tensor] = None
    counters: Optional[object] = None


def _device_outputs(run: _Run) -> DeviceOutputs:
    res = run.res
    dev = res.linkage.device
    direction = torch.cat([res.direction.new_zeros(1), res.direction])
    conv = torch.zeros(direction.shape[0], dtype=torch.bool, device=dev)
    conv[res.converging.long()] = True
    return DeviceOutputs(
        tmfg=run.tm, direction=direction, conv_mask=conv,
        cluster_of=res.cluster_of, bubble_of=res.bubble_of, apsp=res.apsp,
        linkage=res.linkage, hubs=res.hubs,
        overflow=(None if run.overflow is None
                  else torch.tensor(run.overflow, device=dev)),
        counters=run.counters)


def _stack(items):
    """Stack a list of like outputs leaf by leaf (tuples field by field)."""
    first = items[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, tuple):
        return type(first)(*[_stack(list(f)) for f in zip(*items)])
    return torch.tensor(items)


def run_pipeline_device(X_or_S, config: PipelineConfig, *,
                        is_similarity: Optional[bool] = None,
                        batched: Optional[bool] = None, caps=None,
                        mesh=None, device=None) -> DeviceOutputs:
    """The fused pipeline with every output left on the device
    (DESIGN.md §12.2): the same run as ``cluster(..., fused=True)`` up
    to, and not including, the linkage's download.

    ``X_or_S`` is a time-series matrix ``(n, L)``, a similarity matrix
    ``(n, n)``, or the batched ``(B, ...)`` form of either;
    ``is_similarity`` disambiguates (default: square trailing dims mean
    similarity, checked for symmetry) and ``batched`` defaults to
    ``ndim == 3`` (the entries run one after another).  Each call's
    (config, input kind, shape, device) is remembered by the recompile
    watchdog; a replay that builds a loop program is alarmed through
    ``obs.trace.record_recompile``.  ``caps`` and ``mesh`` are
    not ported (the fused approx body takes the reference's caps from
    n) and raise NotImplementedError.  ``device`` defaults to CUDA."""
    if config.dbht_impl != "device":
        raise ValueError(
            "run_pipeline_device IS the device program; "
            "config.dbht_impl='host' has no fused form — use "
            "cluster(..., fused=False) for the numpy oracle")
    if config.filter == "pmfg":
        raise ValueError(
            "filter='pmfg' has no fused form: greedy planarity-checked "
            "insertion is the host-orchestrated reference (DESIGN.md "
            "§18.3) — use cluster(..., fused=False)")
    _no_mesh(mesh)
    if caps is not None:
        raise NotImplementedError(
            "caps= is not ported: the fused approx body takes the "
            "reference's slot caps from n (fused_approx.fused_caps)")
    dev = resolve_device(device)
    arr = _as_f32(X_or_S, dev)
    if batched is None:
        batched = arr.ndim == 3
    square = arr.shape[-1] == arr.shape[-2]
    if config.clean == "rmt" and (is_similarity
                                  or (is_similarity is None and square)):
        raise ValueError(
            "clean='rmt' needs the raw series X: the Marchenko–Pastur "
            "bulk edge comes from the (n, T) window shape (DESIGN.md "
            "§18.2) — a precomputed similarity has no T")
    if is_similarity is None:
        is_similarity = square
        if is_similarity and not bool(
                (arr - arr.transpose(-1, -2)).abs().le(1e-5).all()):
            raise ValueError(
                f"square input {tuple(arr.shape)} is not symmetric, so it "
                f"is ambiguous: pass is_similarity= explicitly")
    entries = list(arr) if batched else [arr]
    with _watch_replay(config, is_similarity, arr.shape, dev, batched):
        outs = [_device_outputs(_run_one(a, is_similarity, config, True,
                                         dev, None, False))
                for a in entries]
    return _stack(outs) if batched else outs[0]


def clear_compiled() -> None:
    """Drop every cached program (``core/jitcache.clear``): the loop
    programs' buffers and CUDA graphs are released once no caller holds
    them, and the allocator's cached blocks go back to the card.  The
    watchdog forgets its keys, so the next call at each is a first one."""
    jitcache.clear()
    _seen_fused.clear()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


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
                        _BATCH_FUSED_REFUSAL, mesh, device)
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
    with (obs_trace.span("pipeline.fused", fence=False, batch=B) if fused
          else contextlib.nullcontext()) as sp:
        with (_watch_replay(cfg, have_S, arr.shape, dev, batched=True)
              if fused else contextlib.nullcontext()):
            runs = [_run_one(arr[b], have_S, cfg, fused, dev, None,
                             collect_timings)
                    for b in range(B)]
        Z = torch.stack([r.res.linkage for r in runs[:B_out]]).cpu().numpy()
        if fused:
            _record_fused_stages(runs)
    if fused:
        _observe_total("fused", sp.duration)
        for r in runs:
            if r.counters is not None:
                _observe_counters(r.counters)
    else:
        _observe_staged(runs)
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
