"""`repro_torch.obs` — tracing, metrics and telemetry export (DESIGN.md §15).

The port of ``repro.obs``, with its public names:

* :mod:`repro_torch.obs.trace` — span-based tracer (fenced through
  :func:`~repro_torch.obs.trace.device_wait` when asked and tracing is
  on), the build counters of the port's loop programs and kernel
  library, and the recompile watchdog (§15.1–§15.2).
* :mod:`repro_torch.obs.metrics` — the process-global registry of
  counters / gauges / histograms (§15.3), a copy of the reference's.
* :mod:`repro_torch.obs.export` — Prometheus text ``render``, JSON-lines
  dump, and the ``torch.profiler`` deep-dive context (§15.4).
"""

from . import export, metrics, trace
from .export import dump_jsonl, profile, render
from .metrics import (REGISTRY, Registry, counter, family_total, gauge,
                      histogram, register_collector, reset, snapshot)
from .trace import (Span, clear, compile_stats, device_wait, disable, enable,
                    enabled, events, record_compile, record_event,
                    record_recompile, record_span, recompile_events, span,
                    spans, tracing, watch_recompiles)

__all__ = [
    "trace", "metrics", "export",
    "Span", "span", "spans", "events", "tracing", "enable", "disable",
    "enabled", "clear", "record_event", "watch_recompiles",
    "compile_stats", "record_recompile", "recompile_events",
    "record_compile", "record_span", "device_wait",
    "REGISTRY", "Registry", "counter", "gauge", "histogram",
    "register_collector", "snapshot", "reset", "family_total",
    "render", "dump_jsonl", "profile",
]
