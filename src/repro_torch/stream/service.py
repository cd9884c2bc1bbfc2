"""ClusterService — the streaming rolling-window façade (DESIGN.md §10.4).

The port of ``repro.stream.service``, with the reference's arguments
plus ``device`` (default: CUDA; ``device="cpu"`` runs the plain PyTorch
path).  It ties the streaming parts together around one rolling window:

    svc = ClusterService(n=500, window=256, k=5, variant="opt")
    for x in ticks:                 # x is one (n,) observation
        svc.tick(x)                 # buffered on the host (§10.1)
    req = svc.submit()              # enqueue clustering of current window
    svc.drain()                     # micro-batched flush (§10.2)
    req.result.labels               # == cluster() on the materialized window

``tick`` only buffers the observation; the buffered ticks are applied
to the co-moment state (on the device) as one ``window_push_block`` at
the next state read, or when the buffer reaches the recluster cadence.
Clustering happens on ``submit``/``drain`` (or every
``recluster_every`` ticks once the window has ``min_ticks``).  Results
flow through the content-hash LRU and the warm-start delta check
(§10.3) before any pipeline work is scheduled, and the micro-batcher
aggregates what remains into bucketed ``cluster_batch`` calls.

With the default thresholds (0.0) the service is *exact*: the labels it
returns equal ``cluster()`` on the window's similarity.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core import jitcache, pipeline
from repro_torch.core.config import ConfigFields, PipelineConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from .admission import AdmissionConfig, AdmissionController, Ticket
from .cache import ResultCache, WarmStart, content_key
from .scheduler import ClusterRequest, MicroBatcher
from .window import (WindowState, window_init, window_push_block,
                     window_similarity)


class ClusterService(ConfigFields):
    """Streaming rolling-window clustering with micro-batching + caching.

    The stage configuration is one :class:`PipelineConfig` (``config``,
    or the ``variant``/``backend``/``dbht_impl`` shim resolved through
    the same funnel — DESIGN.md §12.1); ``self.cfg`` is the single
    object every downstream key (batching, content cache, warm start)
    derives from.
    """

    def __init__(self, n: int, window: int, *, k: Optional[int] = None,
                 variant: Optional[str] = None,
                 config: Optional[PipelineConfig] = None,
                 backend: Optional[str] = None, mesh=None,
                 max_batch: int = 8, cache_size: int = 128,
                 reuse_threshold: float = 0.0, tmfg_threshold: float = 0.0,
                 recluster_every: int = 0, min_ticks: Optional[int] = None,
                 dbht_impl: Optional[str] = None,
                 admission: Optional[AdmissionConfig] = None,
                 clock=None, device=None):
        if config is None and variant is None:
            variant = "opt"                    # the historical default
        self.cfg = PipelineConfig.resolve(
            variant, config, backend=backend, dbht_impl=dbht_impl)
        self.k = k
        self.device = pipeline.resolve_device(device)

        self.state: WindowState = window_init(n, window, device=self.device)
        self.cache = ResultCache(cache_size)
        self.warm = WarmStart(reuse_threshold, tmfg_threshold)
        self.batcher = MicroBatcher(max_batch=max_batch, mesh=mesh,
                                    cache=self.cache, device=self.device)
        # production front door (DESIGN.md §16): bounded queue, quotas,
        # breaker + degraded mode.  Off (None) preserves the synchronous
        # warm/LRU/batcher path exactly; the clock is injectable so the
        # fault suite can drive breaker cooldowns without sleeping.
        self.clock = clock if clock is not None else time.monotonic
        self.admission: Optional[AdmissionController] = None
        if admission is not None:
            self.admission = AdmissionController(
                batcher=self.batcher, cfg=self.cfg, policy=admission,
                cache=self.cache, clock=self.clock, device=self.device)
        self.recluster_every = recluster_every
        self.min_ticks = min_ticks if min_ticks is not None else window
        self.ticks = 0
        # ticks buffered host-side, applied by one window_push_block
        # (one host-to-device copy of the block) at the next state read
        # (similarity/submit), or when the buffer reaches the recluster
        # cadence (DESIGN.md §10.1)
        self._pending: List[np.ndarray] = []
        self._flush_block = recluster_every if recluster_every > 0 else 32
        self.latest: Optional[pipeline.ClusterResult] = None
        self._warm_k: Optional[int] = None
        self.warm_hits = 0
        # per-tick latency lands in the process-global registry
        # (DESIGN.md §15.3); tick() is the service's hottest entry
        # point, so the histogram's O(#buckets) observe is all it pays
        self._m_tick = obs_metrics.histogram(
            "service_tick_seconds", "per-tick co-moment update latency")
        self._m_warm = obs_metrics.counter(
            "service_warm_hits_total", "requests answered by a warm tier")
        # kwarg-era accessors (svc.method/prefix/...) come from the
        # ConfigFields mixin, delegating to self.cfg

    # -- streaming ----------------------------------------------------------
    def tick(self, x) -> Optional[ClusterRequest]:
        """Ingest one (n,) observation; O(n²) amortized.  Auto-submits a
        recluster of the current window every ``recluster_every`` ticks
        once ``min_ticks`` observations have arrived (0 disables).

        The observation is buffered host-side and applied — together
        with every other tick since the last state read — by one
        ``window_push_block`` at the next ``similarity()`` /
        ``submit()``: bitwise the same state as tick-at-a-time pushes,
        with one host-to-device copy per block.  Read ``self.state``
        only through :meth:`similarity`/:meth:`_flush_ticks`.
        """
        t0 = time.perf_counter()
        self._pending.append(np.asarray(x, np.float32))
        self.ticks += 1
        # host-side fill tracking (ticks still in the buffer count too)
        filled = min(self.ticks, self.state.capacity)
        out = None
        if (self.recluster_every > 0
                and filled >= self.min_ticks
                and self.ticks % self.recluster_every == 0):
            out = self.submit()                    # flushes via similarity()
        elif len(self._pending) >= self._flush_block:
            self._flush_ticks()
        self._m_tick.observe(time.perf_counter() - t0)
        return out

    def _flush_ticks(self) -> WindowState:
        """Apply buffered ticks (one block push) and return the
        up-to-date window state."""
        if self._pending:
            X = np.stack(self._pending, axis=1)
            self.state = window_push_block(self.state, X)
            self._pending.clear()
        return self.state

    def similarity(self) -> np.ndarray:
        """Current window's (n, n) Pearson matrix from the co-moments
        (a host copy: the content key hashes it, the warm tier compares
        it)."""
        return window_similarity(self._flush_ticks()).cpu().numpy()

    # -- request path -------------------------------------------------------
    def submit(self, S=None, *, k: Optional[int] = None,
               tenant: str = "default"):
        """Enqueue a clustering request (current window if ``S`` is None).

        Warm-start and cache tiers may answer immediately (``req.done``);
        otherwise the request waits for the next ``drain``.  With
        admission control enabled the request routes through the §16
        front door instead — quotas, bounded queue, breaker — and the
        return value is a :class:`~repro_torch.stream.admission.Ticket`
        (same ``done``/``result``/``cached`` surface, plus the
        admission ``outcome`` and the ``degraded`` label); ``tenant``
        selects the quota bucket and is ignored otherwise.

        ``S`` must be the (n, n) similarity matrix of this service's
        universe.  Anything else — in particular a raw (n, L) series
        window — is rejected, never silently truncated or reinterpreted;
        feed observations through :meth:`tick` or reduce the window with
        ``ops.pearson`` first.
        """
        S = self.similarity() if S is None else np.asarray(S, np.float32)
        n = self.state.n
        if S.ndim != 2 or S.shape[0] != S.shape[1] or S.shape[0] != n:
            raise ValueError(
                f"submit() needs the ({n}, {n}) similarity matrix of this "
                f"service's universe, got shape {S.shape}; raw series "
                "windows are not accepted (and are never truncated) — "
                "feed observations through tick() or pass "
                "S=ops.pearson(window)")
        kk = self.k if k is None else k
        if self.admission is not None:
            t = self.admission.submit(S, k=kk, tenant=tenant)
            if t.done and t.result is not None and not t.degraded:
                self.latest = t.result
            return t
        # uid=-1 marks "answered without queueing"; req.config is the ONE
        # key schema — (k,) + cfg.content_key(), the same tuple the
        # batcher digests for its LRU and in-flush dedupe, so service-
        # and batcher-written entries match (DESIGN.md §12.1)
        req = ClusterRequest(uid=-1, S=S, k=kk, cfg=self.cfg)

        tier, payload = self.warm.lookup(S)
        if tier == "reuse":
            res = payload
            kk_eff = kk if kk is not None else len(payload.dbht.converging)
            if kk_eff != self._warm_k:
                # same window, different requested cut: re-cut the cached
                # dendrogram instead of handing back the wrong k
                res = pipeline.ClusterResult(
                    labels=payload.labels_at(kk_eff), linkage=payload.linkage,
                    tmfg=payload.tmfg, dbht=payload.dbht,
                    edge_sum=payload.edge_sum,
                    reused_tmfg=payload.reused_tmfg)
            req.result, req.done, req.cached = res, True, True
            self.warm_hits += 1
            self._m_warm.inc()
            self.latest = res
            return req
        if tier == "tmfg":
            res = pipeline.cluster(S=S, k=kk, reuse_tmfg=payload,
                                   config=self.cfg, device=self.device)
            req.result, req.done = res, True
            self.warm_hits += 1
            self._m_warm.inc()
            # warm-tier results feed the LRU too: a repeated window must
            # hit the cache even after the warm state has moved on
            self.cache.put(content_key(S, req.config), res)
            self._record(S, res, kk)
            return req

        ck = content_key(S, req.config)
        hit = self.cache.get(ck)
        if hit is not None:
            req.result, req.done, req.cached = hit, True, True
            self._record(S, hit, kk)
            return req

        req = self.batcher.submit(S, k=kk, config=self.cfg)
        req.ck = ck                        # digest already paid for above
        return req

    def drain(self) -> List[ClusterRequest]:
        """Flush the micro-batcher; returns the resolved requests.  With
        admission enabled this pumps the §16.1 queue instead (one bucket
        per call, breaker-accounted) and returns the resolved Tickets."""
        if self.admission is not None:
            done: List[Ticket] = self.admission.pump()
            for t in done:
                if t.result is not None and not t.degraded:
                    self._record(t.S, t.result, t.k)
            return done
        done = self.batcher.flush()
        for r in done:
            if r.result is not None:
                self._record(r.S, r.result, r.k)
        return done

    def recluster(self) -> pipeline.ClusterResult:
        """Synchronous submit+drain of the current window."""
        req = self.submit()
        while not req.done and self.admission is not None \
                and len(self.admission.queue) > 0:
            self.drain()
        if not req.done:
            self.drain()
        return req.result

    def _record(self, S, res, k: Optional[int]) -> None:
        # drift anchoring follows the result itself: a topology carried
        # over from an earlier window (reused_tmfg) must not re-anchor
        # _S_topo — not even when the result arrives via the LRU, whose
        # byte-identical hit may wrap a reused topology
        self.warm.update(S, res,
                         fresh_topology=not getattr(res, "reused_tmfg",
                                                    False))
        # effective cut of the recorded result: the reuse tier must re-cut
        # when a later request asks for a different k
        self._warm_k = k if k is not None else len(res.dbht.converging)
        self.latest = res

    # -- observability (DESIGN.md §15.3) ------------------------------------
    def stats(self) -> Dict[str, Any]:
        """One registry snapshot of everything the serving tier exports:
        jitcache hit/miss/eviction + size, content-cache (LRU) hits and
        misses, batcher occupancy (queue depth, flush sizes, pad waste,
        per-bucket fill), the per-stage pipeline latency histograms and
        the per-tick service latency — plus the service's own local
        counters under ``service_*`` keys.  Keys are Prometheus sample
        names (``repro_torch.obs.export.render`` emits the same registry as
        text)."""
        snap = obs_metrics.snapshot()
        snap.update({
            "service_ticks": float(self.ticks),
            "service_queue_depth": float(len(self.batcher)),
            "service_cache_entries": float(len(self.cache)),
            "service_warm_hits": float(self.warm_hits),
            "service_batches_run": float(self.batcher.batches_run),
            "service_dedup_hits": float(self.batcher.dedup_hits),
        })
        if self.admission is not None:
            snap.update({f"service_{k}": v
                         for k, v in self.admission.stats().items()})
        return snap

    def healthz(self) -> Dict[str, Any]:
        """Liveness/readiness probe (DESIGN.md §15.3).

        Contract (the reference's): always returns the keys
        ``status`` (``"warming"`` until the window holds ``min_ticks``
        observations, then ``"ok"``; ``"degraded"`` while the §16.3
        breaker is not closed), ``ready`` (bool mirror),
        ``ticks``, ``window_filled``, ``window_capacity``,
        ``queue_depth``, ``recompile_events`` (the §15.2 watchdog's
        cumulative alarm count — a healthy steady-state service shows
        0), ``jitcache_size`` — plus the §16 serving keys ``breaker``
        (state string, ``"disabled"`` without admission),
        ``admission_queue_depth``, ``shed_total`` and
        ``degraded_total``."""
        filled = min(self.ticks, self.state.capacity)
        ready = filled >= self.min_ticks
        breaker = "disabled" if self.admission is None \
            else self.admission.breaker.state
        status = "ok" if ready else "warming"
        if breaker not in ("disabled", "closed"):
            status = "degraded"
        adm = self.admission
        return {
            "status": status,
            "ready": ready,
            "ticks": self.ticks,
            "window_filled": filled,
            "window_capacity": self.state.capacity,
            "queue_depth": len(self.batcher),
            "recompile_events": obs_trace.compile_stats()[
                "recompile_events"],
            "jitcache_size": jitcache.size(),
            "breaker": breaker,
            "admission_queue_depth": 0 if adm is None else len(adm),
            "shed_total": 0 if adm is None else adm.shed_total,
            "degraded_total": 0 if adm is None else adm.degraded_total,
        }
