"""Micro-batching request scheduler for clustering (DESIGN.md §10.2).

The port of ``repro.stream.scheduler``: concurrent requests for
TMFG-DBHT clustering are aggregated into *bucketed* ``cluster_batch``
calls instead of running one by one.

Why bucketing matters in the port: each fused (config, batch shape) is
one key the recompile watchdog remembers, and the lazy TMFG's loop
program (``core/jitcache.py``, one per device) is keyed by (n, K, T,
device).  Padding every micro-batch up to the next bucket size (powers
of two by default) bounds the distinct batch shapes to log2(max_batch),
so after warm-up a flush at one n builds nothing — the recompile
watchdog stays silent.  Requests that alternate between two n rebuild
the program at each switch.  Pad entries
repeat real matrices; ``cluster_batch(limit=B)`` keeps their outputs on
the device, and their results are dropped on unpad.
:meth:`MicroBatcher.clear_compiled` empties the cache explicitly.

Requests are grouped by *compatibility key* — ``(n, k, cfg)`` with
``cfg`` the request's hashable :class:`PipelineConfig` — because only
same-shaped, same-config matrices can share one call.  ``device``
(default: CUDA) is where the batcher's ``cluster_batch`` calls run.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import pipeline
from repro_torch.core.config import ConfigFields, PipelineConfig
from repro_torch.obs import metrics as obs_metrics


_UIDS = itertools.count()


@dataclass(eq=False)        # identity semantics: the S field is an ndarray
class ClusterRequest(ConfigFields):
    """One pending clustering request; filled in place at flush time.

    The stage configuration is one :class:`PipelineConfig` (``cfg``);
    the kwarg-era field names (``method``/``prefix``/...) remain
    readable through the :class:`ConfigFields` mixin for callers of
    the old surface.
    """

    uid: int
    S: np.ndarray                      # (n, n) similarity
    k: Optional[int] = None
    cfg: PipelineConfig = field(default_factory=PipelineConfig)
    # filled by the scheduler
    result: Optional[pipeline.ClusterResult] = None
    done: bool = False
    cached: bool = False               # answered from the result cache
    ck: Optional[str] = None           # memoized content digest

    @property
    def key(self) -> Tuple:
        """Compatibility key: requests sharing it batch together.  The
        full config participates (one ``cluster_batch`` call runs a
        single config — including ``dbht_impl``, which selects the
        execution strategy for the whole bucket)."""
        return (self.S.shape[0], self.k, self.cfg)

    @property
    def config(self) -> Tuple:
        """Static config portion (content-cache key material): ``k``
        plus :meth:`PipelineConfig.content_key`, which deliberately
        excludes ``dbht_impl`` — it selects an execution strategy, not
        semantics (the §11.4 parity contract makes device and host
        results identical, up to the adversarial float32 near-tie
        caveat stated there), so cached results are shared across
        impls."""
        return (self.k,) + self.cfg.content_key()


def bucket_size(b: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket ≥ b (the largest bucket caps a single flush)."""
    for s in buckets:
        if s >= b:
            return s
    return buckets[-1]


class MicroBatcher:
    """Aggregates submitted requests into bucketed ``cluster_batch`` calls.

    ``submit()`` only enqueues; ``flush()`` does the work: group by
    compatibility key, answer content-cache hits, pad each group to its
    bucket, run one ``cluster_batch`` per bucket, unpad, fill results.
    """

    def __init__(self, *, max_batch: int = 8,
                 buckets: Optional[Tuple[int, ...]] = None,
                 mesh=None, cache=None, device=None):
        if buckets is None:
            # powers of two up to — and always including — max_batch, so
            # a full flush of max_batch compatible requests is one batch
            # even when max_batch itself is not a power of two
            buckets = tuple(2 ** i for i in range(max_batch.bit_length())
                            if 2 ** i < max_batch) + (max_batch,)
        assert all(b > 0 for b in buckets)
        self.buckets = tuple(sorted(set(buckets)))
        self.max_batch = self.buckets[-1]
        self.mesh = mesh
        self.device = device
        self.cache = cache                 # Optional[cache.ResultCache]
        self.queue: List[ClusterRequest] = []
        self.batches_run = 0
        self.requests_run = 0
        # flush-level dedupe: requests resolved at flush time WITHOUT
        # pipeline work — the cache re-probe (``peek``) answers plus
        # same-flush duplicate matrices resolved from their twin.  The
        # caller-facing cache stats deliberately skip the re-probe
        # (each request counts once, at submit), so without this
        # counter flush dedupe was invisible (DESIGN.md §15.3).
        self.dedup_hits = 0
        self.flushes = 0
        self.pad_slots = 0                 # pad entries ever stacked
        self.batch_slots = 0               # total stacked slots (incl. pads)
        # occupancy instruments in the process-global registry
        self._m_queue = obs_metrics.gauge(
            "batcher_queue_depth", "requests waiting for a flush")
        self._m_flush = obs_metrics.histogram(
            "batcher_flush_size", "real requests per flushed chunk",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0))
        self._m_pad = obs_metrics.gauge(
            "batcher_pad_waste_ratio", "pad slots / stacked slots, lifetime")
        self._m_dedup = obs_metrics.counter(
            "batcher_dedup_hits_total", "requests deduped at flush time")

    def __len__(self) -> int:
        return len(self.queue)

    def submit(self, S, *, k: Optional[int] = None,
               config: Optional[PipelineConfig] = None,
               variant: Optional[str] = None, **cfg_kwargs) -> ClusterRequest:
        """Enqueue one similarity matrix for clustering.

        ``config`` is the preferred configuration surface; ``variant``
        plus loose kwargs remain as the deprecated shim, resolved
        through the same :meth:`PipelineConfig.resolve` funnel as
        ``cluster()`` — so the batched path resolves the exact config
        (and content-cache key) the single-matrix path would.
        """
        cfg = PipelineConfig.resolve(variant, config, **cfg_kwargs)
        req = ClusterRequest(uid=next(_UIDS),
                             S=np.asarray(S, dtype=np.float32), k=k, cfg=cfg)
        self.queue.append(req)
        self._m_queue.set(len(self.queue))
        return req

    @staticmethod
    def clear_compiled() -> None:
        """Drop every cached program (the shared bounded cache the
        buckets build into — ``pipeline.clear_compiled``)."""
        pipeline.clear_compiled()

    # -- flushing -----------------------------------------------------------
    def _content_key(self, r: ClusterRequest) -> str:
        """Content digest of a request, computed at most once: hashing an
        (n, n) float32 matrix is megabytes of SHA-1 at production n, so
        the digest is memoized on the request (the service pre-computes
        it on its own cache probe and hands it down)."""
        if r.ck is None:
            from .cache import content_key
            r.ck = content_key(r.S, r.config)
        return r.ck

    def _run_group(self, reqs: List[ClusterRequest]) -> None:
        r0 = reqs[0]
        for chunk_start in range(0, len(reqs), self.max_batch):
            chunk = reqs[chunk_start:chunk_start + self.max_batch]
            B = len(chunk)
            pad_to = bucket_size(B, self.buckets)
            stack = np.stack([r.S for r in chunk]
                             + [chunk[-1].S] * (pad_to - B))
            bres = pipeline.cluster_batch(
                S=stack, k=r0.k, config=r0.cfg, mesh=self.mesh, limit=B,
                device=self.device)
            self.batches_run += 1
            self.requests_run += B
            # occupancy telemetry (DESIGN.md §15.3): how full this
            # bucket ran, and the lifetime share of padded-away slots
            self.pad_slots += pad_to - B
            self.batch_slots += pad_to
            self._m_flush.observe(float(B))
            self._m_pad.set(self.pad_slots / max(self.batch_slots, 1))
            obs_metrics.gauge("batcher_bucket_occupancy",
                              "last fill fraction of this bucket size",
                              bucket=str(pad_to)).set(B / pad_to)
            for r, res in zip(chunk, bres.results):   # pads drop here
                r.result, r.done = res, True
                if self.cache is not None:
                    self.cache.put(self._content_key(r), res)

    def flush(self) -> List[ClusterRequest]:
        """Resolve every queued request; returns them in submit order.

        Cache hits (and duplicate matrices submitted within one flush)
        never reach the pipeline: only the first of each content key is
        clustered; duplicates are resolved from their twin afterwards —
        never through the LRU, which may have evicted the entry by then.
        The cache re-probe uses ``peek`` so hit/miss statistics count
        each request once (at the caller-facing ``submit``/``get``).

        The queue is taken over up front: if a pipeline stage raises
        mid-flush, the exception propagates with the queue already
        cleared — unresolved requests stay ``done=False`` but are never
        silently re-clustered (or double-resolved) by a later flush.

        An empty queue is a no-op: no flush is counted, no instrument
        moves (pinned by tests/test_torch_stream.py — a service draining on a
        timer must not inflate flush statistics while idle).
        """
        if not self.queue:
            return []
        out, self.queue = self.queue, []
        self.flushes += 1
        self._m_queue.set(0)
        dedupe = self.cache is not None and self.cache.maxsize > 0
        todo: List[ClusterRequest] = []
        first: Dict[str, ClusterRequest] = {}
        dups: List[ClusterRequest] = []
        probe_hits = 0
        for r in out:
            if dedupe:
                ck = self._content_key(r)
                hit = self.cache.peek(ck)
                if hit is not None:
                    r.result, r.done, r.cached = hit, True, True
                    probe_hits += 1
                    continue
                if ck in first:
                    dups.append(r)         # resolved from its twin below
                    continue
                first[ck] = r
            todo.append(r)

        groups: Dict[Tuple, List[ClusterRequest]] = {}
        for r in todo:
            groups.setdefault(r.key, []).append(r)
        for reqs in groups.values():
            self._run_group(reqs)

        for r in dups:
            twin = first[r.ck]
            r.result, r.done, r.cached = twin.result, True, True
        saved = probe_hits + len(dups)
        if saved:
            self.dedup_hits += saved
            self._m_dedup.inc(saved)
        return out
