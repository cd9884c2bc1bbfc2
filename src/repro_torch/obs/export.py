"""Telemetry export: Prometheus text, JSON-lines, profiler (§15.4).

The port of ``repro.obs.export``; three ways out of the process for
what ``obs.trace`` / ``obs.metrics`` collected:

* :func:`render` — the registry in Prometheus text exposition format
  (``# HELP``/``# TYPE`` + samples, histograms as cumulative
  ``_bucket``/``_sum``/``_count``), deterministically ordered: the
  reference's text for the same registry.
* :func:`dump_jsonl` — spans, events and a metrics snapshot as one
  JSON object per line.
* :func:`profile` — ``torch.profiler`` with the CPU and (where there is
  a card) CUDA activities around any region, written as a Chrome trace
  file (which Perfetto opens) into ``logdir``.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Optional

import torch

from . import metrics as _metrics
from . import trace as _trace


def render(registry: Optional[_metrics.Registry] = None) -> str:
    """The registry in Prometheus text exposition format."""
    reg = registry if registry is not None else _metrics.REGISTRY
    lines = []
    seen = set()
    by_family = {}
    for m in reg._instruments():
        by_family.setdefault(m.name, m)
    for name in sorted(by_family):
        m = by_family[name]
        help_text = reg.help_text(name)
        if help_text:
            lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {m.kind}")
        seen.add(name)
    # samples, grouped: instrument samples in family order, then
    # collector samples as untyped gauges
    sample_lines = []
    collector_lines = []
    for sname, labels, value in reg.collect():
        family = sname
        for suffix in ("_bucket", "_sum", "_count"):
            if sname.endswith(suffix) and sname[:-len(suffix)] in seen:
                family = sname[:-len(suffix)]
        line = f"{sname}{_metrics._labels_str(labels)} {_num(value)}"
        (sample_lines if family in seen else collector_lines).append(line)
    lines.extend(sample_lines)
    for line in sorted(collector_lines):
        lines.append(line)
    # an empty registry renders as the empty string, not a stray
    # newline — scrapes of a fresh process must be byte-clean (pinned
    # by tests/test_torch_obs.py)
    return "\n".join(lines) + "\n" if lines else ""


def _num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def dump_jsonl(path: str, *, registry: Optional[_metrics.Registry] = None,
               include_spans: bool = True,
               include_metrics: bool = True) -> int:
    """Write collected spans/events + a metrics snapshot as JSON lines;
    returns the number of lines written."""
    reg = registry if registry is not None else _metrics.REGISTRY
    lines = []
    if include_spans:
        for sp in _trace.spans():
            lines.append(sp.to_dict())
        lines.extend(_trace.events())
        lines.extend(_trace.recompile_events())
    if include_metrics:
        lines.append(dict(kind="metrics", t=time.time(),
                          samples=reg.snapshot(),
                          compile=_trace.compile_stats()))
    with open(path, "w") as f:
        for obj in lines:
            f.write(json.dumps(obj, default=str) + "\n")
    return len(lines)


@contextmanager
def profile(logdir: str, *, create_perfetto_trace: bool = False):
    """Deep-dive profiler context: ``torch.profiler`` over the region,
    with CUDA activity where a card is present, and span tracing enabled
    so the coarse spans land next to the per-op timeline.  On exit the
    trace is written to ``logdir`` as ``trace-<pid>-<ms>.json`` (Chrome
    trace format; Perfetto opens it — ``create_perfetto_trace`` is
    accepted for the reference's signature and changes nothing).
    Yields the profiler; its ``trace_path`` attribute is set on exit."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with _trace.tracing():
        with torch_profile(activities=acts) as prof:
            yield prof
    path = os.path.join(logdir, f"trace-{os.getpid()}-"
                                f"{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path
