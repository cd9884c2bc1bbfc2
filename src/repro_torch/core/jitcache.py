"""Bounded cache of the port's compiled programs (DESIGN.md §12.3).

The port of ``repro.core.jitcache``: one shared, *bounded* LRU with the
reference's functions and its ``jitcache`` collector in the metrics
registry.  What XLA keeps as a compiled executable, the port keeps as a
**loop program** (``core/tmfg.LoopProgram``): the lazy TMFG loop's
source and state buffers and, on a card, the CUDA graph captured over
them, keyed by (builder, n, K, T, device).  A replay copies its inputs
into the buffers and replays the graph, so a serving loop at one shape
captures once.  The cache holds loop programs only.

Eviction drops the entry, which releases its buffers and graph once no
caller holds it.  Besides the LRU bound (64), :func:`evict` drops the
entries a predicate selects: a loop program that misses evicts the other
programs on its device first (``core/tmfg.cached_program``), so at most
one set of (n, n) or (n, L) source buffers is live per device and a
steady-state service at one shape keeps its program.
:func:`nbytes` sums the device bytes the live entries hold.

Observability (DESIGN.md §15.3): the hit/miss/eviction counters, the
live size and the LRU head's idle age are exported through the
``repro_torch.obs`` metrics registry (collector ``jitcache``), each entry
carries a last-hit timestamp (:func:`last_hit_ages`), and
:func:`reset_stats` zeroes the counters (``clear()`` keeps them).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable

from repro_torch.obs import metrics as _obs_metrics

DEFAULT_MAXSIZE = 64

# the lru_caches this module replaces were internally locked; concurrent
# submitters sharing the stream service get the same guarantee here
_lock = threading.RLock()
_cache: "OrderedDict[Hashable, Any]" = OrderedDict()
_maxsize = DEFAULT_MAXSIZE
_stats: Dict[str, int] = {"hits": 0, "misses": 0, "evictions": 0}
# monotonic last-access (create or hit) per live key; evicted with it
_last_hit: Dict[Hashable, float] = {}


def cached(key: Hashable, build: Callable[[], Any]) -> Any:
    """The executable for ``key``, building (and caching) it on miss."""
    with _lock:
        if key in _cache:
            fn = _cache[key]
            _cache.move_to_end(key)
            _stats["hits"] += 1
            _last_hit[key] = time.monotonic()
            return fn
        fn = build()
        _stats["misses"] += 1
        _cache[key] = fn
        _last_hit[key] = time.monotonic()
        while len(_cache) > _maxsize:
            old, _ = _cache.popitem(last=False)
            _last_hit.pop(old, None)
            _stats["evictions"] += 1
        return fn


def contains(key: Hashable) -> bool:
    """Whether ``key`` is live in the cache, without touching LRU order
    or statistics."""
    with _lock:
        return key in _cache


def evict(pred: Callable[[Hashable], bool]) -> int:
    """Drop every entry whose key satisfies ``pred`` (counted as
    evictions); returns how many went."""
    with _lock:
        gone = [k for k in _cache if pred(k)]
        for k in gone:
            del _cache[k]
            _last_hit.pop(k, None)
        _stats["evictions"] += len(gone)
        return len(gone)


def clear() -> None:
    """Drop every cached executable (stats are kept)."""
    with _lock:
        _cache.clear()
        _last_hit.clear()


def reset_stats() -> None:
    """Zero the hit/miss/eviction counters (DESIGN.md §15.3): a
    long-lived process measuring per-run hit rates must not average
    against every run that came before."""
    with _lock:
        for k in _stats:
            _stats[k] = 0


def size() -> int:
    with _lock:
        return len(_cache)


def keys():
    """Snapshot of the cached keys, LRU-first (introspection/tests)."""
    with _lock:
        return list(_cache)


def stats() -> Dict[str, int]:
    """Copy of the hit/miss/eviction counters."""
    with _lock:
        return dict(_stats)


def last_hit_ages() -> Dict[Hashable, float]:
    """Seconds since each live key was last served (LRU-first order) —
    the per-key staleness behind the eviction gauge (DESIGN.md §15.3)."""
    now = time.monotonic()
    with _lock:
        return {k: now - _last_hit[k] for k in _cache}


def oldest_idle_s() -> float:
    """Idle age of the LRU head — the next eviction victim's staleness
    (0.0 when empty)."""
    with _lock:
        if not _cache:
            return 0.0
        head = next(iter(_cache))
        return time.monotonic() - _last_hit[head]


def nbytes() -> int:
    """Bytes held by the live entries' tensors (an entry reports its own
    through an ``nbytes()`` method; the others count 0)."""
    with _lock:
        entries = list(_cache.values())
    return int(sum(e.nbytes() for e in entries if hasattr(e, "nbytes")))


def set_maxsize(n: int) -> int:
    """Set the bound (evicting down to it); returns the previous bound."""
    global _maxsize
    if n < 1:
        raise ValueError(f"maxsize must be >= 1, got {n}")
    with _lock:
        prev, _maxsize = _maxsize, n
        while len(_cache) > _maxsize:
            old, _ = _cache.popitem(last=False)
            _last_hit.pop(old, None)
            _stats["evictions"] += 1
        return prev


def _collect() -> Dict[str, float]:
    with _lock:
        return {
            "jitcache_hits_total": _stats["hits"],
            "jitcache_misses_total": _stats["misses"],
            "jitcache_evictions_total": _stats["evictions"],
            "jitcache_size": len(_cache),
            "jitcache_oldest_idle_seconds": oldest_idle_s(),
        }


_obs_metrics.register_collector("jitcache", _collect)
