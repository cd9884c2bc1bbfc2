"""Span-based device-true tracer + recompile watchdog (DESIGN.md §15.1).

The port of ``repro.obs.trace``, with the reference's public names:

* :func:`span` — a nestable, thread-safe timing context.  Spans always
  measure (callers read ``sp.duration``); they are *collected* into the
  global trace buffer only while tracing is enabled (:func:`enable` /
  :func:`tracing`), so the buffer costs nothing in steady state.
  :func:`record_span` adds a span timed elsewhere — the pipeline's stage
  spans, from the stage clock of ``core/pipeline.py`` (fenced on the
  staged path, CUDA events on the fused one).
* device-true fencing — ``sp.fence(x)`` waits for the device work behind
  ``x`` only when the span was opened with ``fence=True`` *and* tracing
  is on.  Every wait the tracer or the staged pipeline makes goes
  through one module-level function, :func:`device_wait`, so a test can
  count them: the fused pipeline makes none (the zero-extra-sync
  contract of §15.1).
* compile-vs-run separation (§15.2) — the port has no XLA compiler to
  listen to.  What it builds instead are loop programs (the lazy TMFG
  loop's buffers and its captured CUDA graph, ``core/tmfg.LoopProgram``)
  and the CUDA kernel library (``kernels/_build.py``); each build calls
  :func:`record_compile`, which feeds the same counters: every span's
  ``compiles`` / ``compile_s``, :func:`compile_stats` and
  :func:`watch_recompiles`.  :func:`record_recompile` is the runtime
  watchdog's alarm, raised by the pipeline when a *replayed* (config,
  shape) call built a new loop program, into an always-on bounded log
  that ``ClusterService.healthz()`` reports.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

_lock = threading.RLock()
_local = threading.local()          # per-thread active-span stack

_enabled = False
_tracing_depth = 0                  # open tracing() sessions, all threads
_records: List["Span"] = []         # completed spans, append order
_events: List[Dict[str, Any]] = []  # trace events (only while enabled)
_MAX_RECORDS = 65536                # hard cap: tracing never grows unbounded

# cumulative build counters (always on; fed by record_compile)
_compile_count = 0
_compile_secs = 0.0

# the runtime recompile watchdog's alarm log: replayed (config, shape)
# calls that built a NEW loop program anyway.  Always on, bounded.
_recompile_log: "deque[Dict[str, Any]]" = deque(maxlen=1024)
_recompile_count = 0


def device_wait(x) -> None:
    """Wait until the device work behind ``x`` is done: ``x`` is a
    tensor, a (nested) tuple/list/dict of tensors, or a ``torch.device``.
    A CUDA device is waited on through its current stream; CPU work is
    already done.  The one place the tracer and the staged pipeline
    wait on the device."""
    devs = {x} if isinstance(x, torch.device) else \
        {t.device for t in _tensors(x)}
    for d in devs:
        if d.type == "cuda":
            torch.cuda.current_stream(d).synchronize()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        yield from _tensors(list(x.values()))
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


# ---------------------------------------------------------------------------
# spans (§15.1)
# ---------------------------------------------------------------------------

@dataclass
class Span:
    """One completed (or active) timing span."""

    name: str
    fenced: bool = False
    depth: int = 0
    parent: Optional[str] = None
    thread: int = 0
    start: float = 0.0
    duration: float = 0.0           # wall seconds, fenced when ``fenced``
    compiles: int = 0               # programs built inside the span
    compile_s: float = 0.0          # their summed build seconds
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def run_s(self) -> float:
        """Duration with the span's build time subtracted — the
        steady-state cost a replay would pay (DESIGN.md §15.2)."""
        return max(self.duration - self.compile_s, 0.0)

    def fence(self, x):
        """Wait for ``x``'s device work — only when the span was opened
        with ``fence=True`` and tracing is on; otherwise NO device sync.
        Returns ``x`` either way."""
        if self.fenced and x is not None and enabled():
            device_wait(x)
        return x

    def to_dict(self) -> Dict[str, Any]:
        return dict(kind="span", name=self.name, depth=self.depth,
                    parent=self.parent, thread=self.thread,
                    start=self.start, duration=self.duration,
                    fenced=self.fenced, compiles=self.compiles,
                    compile_s=self.compile_s, run_s=self.run_s,
                    **({"attrs": self.attrs} if self.attrs else {}))


def _stack() -> List[Span]:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _collect(sp: Span) -> None:
    with _lock:
        if (_enabled or _tracing_depth) and len(_records) < _MAX_RECORDS:
            _records.append(sp)


@contextmanager
def span(name: str, *, fence: bool = False, **attrs):
    """Time a region; nestable and thread-safe (each thread keeps its
    own stack).  The span object is yielded so callers can read
    ``sp.duration`` / ``sp.run_s`` afterwards and ``sp.fence(value)``
    device outputs at stage boundaries.

    Spans always measure; they are appended to the global trace buffer
    only while tracing is :func:`enable`\\ d."""
    st = _stack()
    sp = Span(name=name, fenced=fence, depth=len(st),
              parent=st[-1].name if st else None,
              thread=threading.get_ident(), attrs=dict(attrs))
    with _lock:
        c0, s0 = _compile_count, _compile_secs
    st.append(sp)
    sp.start = time.perf_counter()
    try:
        yield sp
    finally:
        sp.duration = time.perf_counter() - sp.start
        st.pop()
        with _lock:
            # cross-thread builds can leak into the delta; single-
            # threaded callers see exact counts
            sp.compiles = _compile_count - c0
            sp.compile_s = _compile_secs - s0
        _collect(sp)


def record_span(name: str, duration: float, *, fenced: bool = False,
                start: Optional[float] = None, **attrs) -> Optional[Span]:
    """Collect a span timed elsewhere (the pipeline's stage clock: fenced
    on the staged path, CUDA events on the fused one) as a child of the
    span open on this thread.  Collected only while tracing is on;
    returns the span, or None when tracing is off."""
    if not enabled():
        return None
    st = _stack()
    sp = Span(name=name, fenced=fenced, depth=len(st),
              parent=st[-1].name if st else None,
              thread=threading.get_ident(),
              start=time.perf_counter() if start is None else start,
              duration=float(duration), attrs=dict(attrs))
    _collect(sp)
    return sp


# ---------------------------------------------------------------------------
# enable/disable + buffer access
# ---------------------------------------------------------------------------

def enable() -> None:
    """Start collecting spans/events into the trace buffer."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled or _tracing_depth > 0


@contextmanager
def tracing():
    """Scoped :func:`enable` (the usual way to take a trace).

    Sessions are *refcounted*, not save/restored: two threads (or two
    nested regions) may hold overlapping ``tracing()`` sessions and
    collection stays on until the LAST one exits."""
    global _tracing_depth
    with _lock:
        _tracing_depth += 1
    try:
        yield
    finally:
        with _lock:
            _tracing_depth -= 1


def spans(name: Optional[str] = None) -> List[Span]:
    """Snapshot of collected spans (optionally filtered by name)."""
    with _lock:
        out = list(_records)
    return out if name is None else [s for s in out if s.name == name]


def events(name: Optional[str] = None) -> List[Dict[str, Any]]:
    with _lock:
        out = list(_events)
    return out if name is None else [e for e in out if e["name"] == name]


def record_event(name: str, **attrs) -> None:
    """Append an instantaneous event to the trace buffer (collected
    only while tracing is enabled)."""
    if not (_enabled or _tracing_depth):
        return
    with _lock:
        if len(_events) < _MAX_RECORDS:
            _events.append(dict(kind="event", name=name,
                                t=time.perf_counter(), **attrs))


def clear() -> None:
    """Drop collected spans/events (build counters are cumulative; see
    :func:`watch_recompiles` for windowed readings)."""
    with _lock:
        _records.clear()
        _events.clear()


# ---------------------------------------------------------------------------
# build counters + the recompile watchdog (§15.2)
# ---------------------------------------------------------------------------

def record_compile(seconds: float, what: str = "") -> None:
    """Count one program build and its seconds: a loop program of the
    lazy TMFG (``core/tmfg.LoopProgram``) or the CUDA kernel library
    (``kernels/_build.py``, when it was not already built).  Always on,
    independent of tracing."""
    global _compile_count, _compile_secs
    with _lock:
        _compile_count += 1
        _compile_secs += float(seconds)
    record_event("compile", what=what, seconds=float(seconds))


def compile_stats() -> Dict[str, float]:
    """Cumulative process-wide build counters (always on)."""
    with _lock:
        return {"programs": _compile_count, "compile_s": _compile_secs,
                "recompile_events": _recompile_count}


class _Watch:
    """View over a watched region's build activity: live while the
    ``with`` block is open, frozen at its deltas once the block exits."""

    def __init__(self):
        with _lock:
            self._c0, self._s0 = _compile_count, _compile_secs
            self._r0 = _recompile_count
        self._end = None                 # (count, secs, recompiles) caps

    def _freeze(self) -> None:
        with _lock:
            self._end = (_compile_count, _compile_secs, _recompile_count)

    def _now(self, i: int):
        if self._end is not None:
            return self._end[i]
        with _lock:
            return (_compile_count, _compile_secs, _recompile_count)[i]

    @property
    def count(self) -> int:
        """Programs built inside the watched region."""
        return self._now(0) - self._c0

    @property
    def compile_s(self) -> float:
        return self._now(1) - self._s0

    @property
    def recompile_events(self) -> int:
        """Watchdog *alarms* (replayed calls that built a program)
        inside the region — distinct from first-time builds."""
        return self._now(2) - self._r0


@contextmanager
def watch_recompiles():
    """Watch a region for program builds (DESIGN.md §15.2).

    ``with watch_recompiles() as w: ...`` — afterwards (or live inside)
    ``w.count``/``w.compile_s`` report the programs built in the region
    and their seconds; the deltas freeze when the block exits.  A replay
    at a fixed (config, shape) must report ``w.count == 0``."""
    w = _Watch()
    try:
        yield w
    finally:
        w._freeze()


def record_recompile(detail: str = "", **attrs) -> None:
    """The runtime watchdog's alarm (DESIGN.md §15.2): called by the
    pipeline when a REPLAYED (config, shape) call built a new loop
    program anyway, which a healthy steady-state service never does.
    Always recorded (bounded log), independent of tracing."""
    global _recompile_count
    with _lock:
        _recompile_count += 1
        _recompile_log.append(dict(kind="event", name="recompile",
                                   t=time.perf_counter(), detail=detail,
                                   **attrs))
    record_event("recompile", detail=detail, **attrs)


def recompile_events() -> List[Dict[str, Any]]:
    """Snapshot of the watchdog's (bounded) alarm log."""
    with _lock:
        return list(_recompile_log)
