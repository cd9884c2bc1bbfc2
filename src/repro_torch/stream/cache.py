"""Result caching for the streaming service (DESIGN.md §10.3).

The port of ``repro.stream.cache``, with its digests and its two
mechanisms, composed by ``service.py``:

* :class:`ResultCache` — a content-hash LRU over finished
  ``ClusterResult``s.  The key is a SHA-1 of the similarity matrix's
  float32 bytes (a host copy of S, wherever S lies) plus the static
  config — ``(k,) + PipelineConfig.content_key()``, the reference's key
  schema — so the port and the reference give one digest for one window.
* :class:`WarmStart` — rolling-window reuse: when the *mean* absolute
  elementwise delta to the previously clustered window is below
  ``reuse_threshold`` the previous result is returned as-is, and below
  ``tmfg_threshold`` the previous TMFG topology is kept and only the
  DBHT stage reruns.  Both default to 0.0: exact streaming semantics
  unless the caller opts in.  The gate is the mean, not the max:
  windowed Pearson entries carry O(1/√L) sampling noise, so some pair
  always swings between reclusters.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Optional, Tuple

import numpy as np

import torch

from repro_torch.obs import metrics as obs_metrics


def _host(S) -> np.ndarray:
    """A host float32 array of S (a tensor is copied off its device)."""
    if isinstance(S, torch.Tensor):
        S = S.detach().to("cpu", torch.float32).numpy()
    return np.asarray(S, dtype=np.float32)


def content_key(S, config: Tuple) -> str:
    """Digest of the similarity matrix bytes + the static config tuple
    (``(k,) + PipelineConfig.content_key()`` in this subsystem)."""
    h = hashlib.sha1()
    arr = np.ascontiguousarray(_host(S))
    h.update(str(arr.shape).encode())
    h.update(arr.tobytes())
    h.update(repr(config).encode())
    return h.hexdigest()


class ResultCache:
    """Content-hash LRU over ClusterResults.  ``maxsize<=0`` disables.

    Hit/miss/eviction counts also land in the process-global metrics
    registry (``stream_cache_*`` counters, DESIGN.md §15.3) — every
    instance reports into the same family, the way a multi-tenant
    service aggregates — while the per-instance ``hits``/``misses``
    attributes keep their pre-§15 meaning."""

    def __init__(self, maxsize: int = 128):
        self.maxsize = maxsize
        self._d: "OrderedDict[str, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.stale_serves = 0
        self._m_hits = obs_metrics.counter(
            "stream_cache_hits_total", "content-hash LRU hits")
        self._m_misses = obs_metrics.counter(
            "stream_cache_misses_total", "content-hash LRU misses")
        self._m_stale = obs_metrics.counter(
            "stream_cache_stale_serves_total",
            "degraded-lane cache serves (DESIGN.md §16.3)")
        self._m_evict = obs_metrics.counter(
            "stream_cache_evictions_total", "content-hash LRU evictions")

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key: str):
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            self._m_hits.inc()
            return self._d[key]
        self.misses += 1
        self._m_misses.inc()
        return None

    def peek(self, key: str):
        """``get`` without touching the hit/miss statistics — for the
        scheduler's internal re-probe of requests the caller-facing path
        already counted."""
        if key in self._d:
            self._d.move_to_end(key)
            return self._d[key]
        return None

    def get_stale(self, key: str):
        """Degraded-lane read (DESIGN.md §16.3): like :meth:`get` but
        counted separately (``stream_cache_stale_serves_total``), so
        overload serving does not distort the steady-state hit rate —
        the statistic capacity decisions are made from."""
        if key in self._d:
            self._d.move_to_end(key)
            self.stale_serves += 1
            self._m_stale.inc()
            return self._d[key]
        return None

    def put(self, key: str, value) -> None:
        if self.maxsize <= 0:
            return
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)
            self._m_evict.inc()


class WarmStart:
    """Previous-window reuse keyed on the similarity delta.

    ``lookup(S)`` returns one of
      ("reuse", prev_result)  — delta ≤ reuse_threshold: previous labels
                                stand (the window barely moved);
      ("tmfg",  prev_tmfg)    — delta ≤ tmfg_threshold: keep the TMFG /
                                hub structure, rerun only DBHT on S;
      (None,    None)         — recompute from scratch.
    ``update(S, result)`` records the window that was actually clustered;
    pass ``fresh_topology=False`` when the result reused an earlier
    TMFG.

    Drift anchoring: the reuse delta is measured against the last
    *clustered* window, but the tmfg delta is measured against the
    window the topology was actually *built* on — otherwise a slow
    drift of per-step deltas below the threshold would chain
    topology reuses forever while total divergence grows unbounded.
    """

    def __init__(self, reuse_threshold: float = 0.0,
                 tmfg_threshold: float = 0.0):
        assert reuse_threshold <= tmfg_threshold or tmfg_threshold == 0.0, \
            "full reuse must be at least as strict as TMFG reuse"
        self.reuse_threshold = reuse_threshold
        self.tmfg_threshold = tmfg_threshold
        self._S: Optional[np.ndarray] = None       # last clustered window
        self._S_topo: Optional[np.ndarray] = None  # topology's source window
        self._result = None
        self.reuses = 0
        self.tmfg_reuses = 0

    @staticmethod
    def _delta(S, base: Optional[np.ndarray]) -> float:
        """Mean absolute elementwise delta (∞ when nothing recorded).
        Mean, not max — a max gate is defeated by the O(1/√L) sampling
        noise of any single windowed-correlation entry (see module
        docstring)."""
        if base is None:
            return float("inf")
        return float(np.mean(np.abs(_host(S) - base)))

    def delta(self, S) -> float:
        return self._delta(S, self._S)

    def lookup(self, S):
        if self._result is None:
            return None, None
        if self._delta(S, self._S) <= self.reuse_threshold:
            self.reuses += 1
            return "reuse", self._result
        if (self.tmfg_threshold > 0.0
                and self._delta(S, self._S_topo) <= self.tmfg_threshold):
            self.tmfg_reuses += 1
            return "tmfg", self._result.tmfg
        return None, None

    def update(self, S, result, *, fresh_topology: bool = True) -> None:
        self._S = _host(S).copy()
        self._result = result
        if fresh_topology:
            self._S_topo = self._S
