"""Process-global metrics registry (DESIGN.md §15.3).

A copy of ``repro.obs.metrics`` (pure Python; the port imports nothing
of the reference): one registry of counters / gauges / histograms that
the port's loop-program cache (``core/jitcache``), the stream result
cache, the approx construction's counters, the micro-batcher's
occupancy gauges and the service/pipeline latency histograms report
into.  ``ClusterService.stats()`` returns one :func:`snapshot` of it;
``repro_torch.obs.export.render`` emits it in Prometheus text format,
with the reference's sample names and text.

Two registration styles:

* *instruments* — ``counter()/gauge()/histogram()`` get-or-create by
  (name, labels) and are updated inline at the call site.  All
  operations are lock-protected and O(1)-ish; safe on hot paths.
* *collectors* — :func:`register_collector` adds a callable returning
  ``{sample_name: value}``, read at snapshot/render time (the
  ``jitcache`` collector is one).

``reset()`` zeroes every owned instrument (collectors are views over
external state and are reset at their source, e.g.
``jitcache.reset_stats()``).
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Callable, Dict, List, Optional, Tuple

# prometheus-style latency buckets (seconds); +Inf is implicit
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

LabelsKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict[str, str]) -> LabelsKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _labels_str(labels: LabelsKey) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


class Counter:
    """Monotonically increasing count."""

    kind = "counter"

    def __init__(self, name: str, labels: LabelsKey, lock):
        self.name, self.labels, self._lock = name, labels, lock
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease by {v}")
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        self._value = 0.0

    def _samples(self):
        yield self.name, self.labels, self.value


class Gauge:
    """Point-in-time value; settable, or backed by a callback."""

    kind = "gauge"

    def __init__(self, name: str, labels: LabelsKey, lock):
        self.name, self.labels, self._lock = name, labels, lock
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, v: float) -> None:
        with self._lock:
            self._value, self._fn = float(v), None

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._value += v

    def dec(self, v: float = 1.0) -> None:
        self.inc(-v)

    def set_fn(self, fn: Callable[[], float]) -> None:
        """Back the gauge with a callback, read at snapshot time."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            return float(self._fn()) if self._fn is not None else self._value

    def _reset(self) -> None:
        if self._fn is None:
            self._value = 0.0

    def _samples(self):
        yield self.name, self.labels, self.value


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name: str, labels: LabelsKey, lock,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        if tuple(sorted(buckets)) != tuple(buckets) or not buckets:
            raise ValueError(f"buckets must be sorted/nonempty: {buckets}")
        self.name, self.labels, self._lock = name, labels, lock
        self.buckets = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.buckets) + 1)   # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        with self._lock:
            self._counts[bisect.bisect_left(self.buckets, v)] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def _reset(self) -> None:
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum, self._count = 0.0, 0

    def _samples(self):
        with self._lock:
            counts, total = list(self._counts), self._count
            s = self._sum
        cum = 0
        for b, c in zip(self.buckets, counts):
            cum += c
            yield (f"{self.name}_bucket",
                   self.labels + (("le", _fmt(b)),), cum)
        yield f"{self.name}_bucket", self.labels + (("le", "+Inf"),), total
        yield f"{self.name}_sum", self.labels, s
        yield f"{self.name}_count", self.labels, total


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    return repr(v) if v != int(v) else str(int(v))


class Registry:
    """Get-or-create instrument registry + snapshot/render surface."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[Tuple[str, LabelsKey], object] = {}
        self._help: Dict[str, str] = {}
        self._collectors: Dict[str, Callable[[], Dict[str, float]]] = {}

    def _get(self, cls, name: str, help: str, labels: Dict[str, str],
             **kw):
        key = (name, _labels_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(name, key[1], self._lock, **kw)
                if help:
                    self._help.setdefault(name, help)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def register_collector(self, name: str,
                           fn: Callable[[], Dict[str, float]]) -> None:
        """Register (or replace) a snapshot-time sample source."""
        with self._lock:
            self._collectors[name] = fn

    def _instruments(self) -> List[object]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def collect(self) -> List[Tuple[str, LabelsKey, float]]:
        """Every sample: owned instruments first, then collectors."""
        out = []
        for m in self._instruments():
            out.extend(m._samples())
        with self._lock:
            collectors = list(self._collectors.items())
        for _, fn in sorted(collectors):
            for name, value in sorted(fn().items()):
                out.append((name, (), float(value)))
        return out

    def snapshot(self) -> Dict[str, float]:
        """One flat ``{'name{labels}': value}`` dict of every sample —
        the payload ``ClusterService.stats()`` exports."""
        return {name + _labels_str(labels): value
                for name, labels, value in self.collect()}

    def family_total(self, name: str) -> float:
        """Sum of one counter/gauge family across every label set —
        e.g. ``family_total("admission_shed_total")`` is total sheds
        regardless of reason (the §16 serving rollup the load bench
        reports).  Histograms are excluded (summing bucket samples is
        meaningless); an unknown family sums to 0.0."""
        with self._lock:
            ms = [m for (n, _), m in self._metrics.items() if n == name]
        return float(sum(m.value for m in ms if hasattr(m, "value")))

    def reset(self) -> None:
        """Zero every owned instrument (collectors are external views;
        reset those at their source)."""
        with self._lock:
            for m in self._metrics.values():
                m._reset()

    def help_text(self, name: str) -> str:
        with self._lock:
            return self._help.get(name, "")


REGISTRY = Registry()

# module-level conveniences bound to the process-global registry
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
register_collector = REGISTRY.register_collector
snapshot = REGISTRY.snapshot
reset = REGISTRY.reset
family_total = REGISTRY.family_total
