"""Incremental rolling-window co-moment state (DESIGN.md §10.1).

The port of ``repro.stream.window``.  The streaming use case recomputes
the Pearson similarity of an (n, L) rolling window every time a tick
arrives.  From scratch that is the full O(n²L) ``ops.pearson``; here the
window's *co-moments* about a per-series shift origin r (each series'
first tick) are kept —

    s1[i]    = Σ_t (x_i(t) − r_i)                  (n,)
    s2[i,j]  = Σ_t (x_i(t) − r_i)(x_j(t) − r_j)    (n, n)

— so appending one tick and evicting the oldest is a rank-1 update:
O(n²) work per tick.  The Pearson matrix follows from the moment
identity ``corr = (s2/m − μμᵀ) / sqrt(var varᵀ)``, μ = s1/m.  The shift
keeps price-like series (level ≫ move size) out of float32 cancellation,
and it is re-anchored to the newest tick each time the ring completes a
pass (the moments recomputed from the ring, O(n²L) once per L ticks).

The sums are float32 with Kahan compensation (the reference's sums with
jax's default 32-bit floats), and every step is the reference's, in its
order of operations.  ``window_similarity`` matches ``ops.pearson`` on
the materialized window to 1e-5.

:class:`WindowState` is a NamedTuple of tensors: the ring buffer, the
shift origin and the sums on the state's device; ``head`` and ``count``,
the ring's bookkeeping, as 0-d int32 tensors on the CPU, so a push (and
the wrap it may trigger) never waits on the device.  A push is a few
elementwise operations on the (n, n) sums, left in plain PyTorch (no
TPU kernel computes it).  Transitions are functional: a push returns a
new state and leaves the old one as it was.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class WindowState(NamedTuple):
    """Rolling-window ring buffer + compensated co-moment sums, about a
    per-series reference point ``ref`` (the series' first tick)."""

    buf: torch.Tensor     # (n, L) ring buffer of ticks, column ``head`` next
    head: torch.Tensor    # () int32, CPU — next write slot
    count: torch.Tensor   # () int32, CPU — valid ticks, ≤ L
    ref: torch.Tensor     # (n,)   per-series shift origin
    s1: torch.Tensor      # (n,)   Σ (x − ref)
    c1: torch.Tensor      # (n,)   compensation for s1
    s2: torch.Tensor      # (n, n) Σ (x − ref)(x − ref)ᵀ
    c2: torch.Tensor      # (n, n) compensation for s2

    @property
    def n(self) -> int:
        return self.buf.shape[0]

    @property
    def capacity(self) -> int:
        return self.buf.shape[1]

    @property
    def device(self) -> torch.device:
        return self.buf.device


def _host_int(v: int) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32)


def window_init(n: int, capacity: int, device=None) -> WindowState:
    """Empty rolling window for n series with ``capacity`` ticks, on
    ``device`` (default: the CPU)."""
    dev = torch.device("cpu" if device is None else device)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return WindowState(buf=z(n, capacity), head=_host_int(0),
                       count=_host_int(0), ref=z(n), s1=z(n), c1=z(n),
                       s2=z(n, n), c2=z(n, n))


def _kahan_add(s, c, d):
    """One compensated accumulation step: (s, c) += d."""
    y = d - c
    t = s + y
    return t, (t - s) - y


def _full_moments(buf: torch.Tensor, ref: torch.Tensor):
    """Moments of the whole ring about a fresh origin — the re-anchor
    path; the compensation terms restart at zero."""
    Z = buf - ref[:, None]
    s1 = Z.sum(dim=1)
    s2 = Z @ Z.T
    return ref, s1, torch.zeros_like(s1), s2, torch.zeros_like(s2)


def _push_step(st: WindowState, x: torch.Tensor) -> WindowState:
    """One append+evict transition (the reference's ``_push_step``); x is
    (n,) float32 on the state's device."""
    L = st.buf.shape[1]
    head, count = int(st.head), int(st.count)
    ref = x if count == 0 else st.ref
    old = st.buf[:, head]
    xd = x - ref
    od = (old - ref) if count == L else torch.zeros_like(xd)

    s1, c1 = _kahan_add(st.s1, st.c1, xd - od)
    s2, c2 = _kahan_add(st.s2, st.c2,
                        torch.outer(xd, xd) - torch.outer(od, od))

    buf = st.buf.clone()
    buf[:, head] = x
    head = (head + 1) % L
    count = min(count + 1, L)
    if head == 0 and count == L:                # completed one full pass
        ref, s1, c1, s2, c2 = _full_moments(buf, x)
    return WindowState(buf=buf, head=_host_int(head),
                       count=_host_int(count), ref=ref, s1=s1, c1=c1,
                       s2=s2, c2=c2)


def _ticks(X, st: WindowState) -> torch.Tensor:
    if isinstance(X, torch.Tensor):
        return X.to(st.device, torch.float32)
    return torch.from_numpy(np.asarray(X, np.float32)).to(st.device)


def window_push(st: WindowState, x) -> WindowState:
    """Append tick x (n,) — evicting the oldest when full — in O(n²)
    amortized; the origin is re-anchored to the newest tick each time
    the ring completes a pass (see the module docstring)."""
    return _push_step(st, _ticks(x, st))


def window_push_block(st: WindowState, X) -> WindowState:
    """Apply a block of B pending ticks (columns of X, (n, B), oldest
    first): bitwise B sequential ``window_push`` calls (the same step, in
    the same order), with one host-to-device copy of the block."""
    Xd = _ticks(X, st)
    for j in range(Xd.shape[1]):
        st = _push_step(st, Xd[:, j])
    return st


def window_similarity(st: WindowState) -> torch.Tensor:
    """(n, n) float32 Pearson matrix of the current window from the
    co-moments, on the state's device: O(n²), no pass over the L ticks.

    Degenerate series — windowed variance below 1e-6 of the shifted
    second moment E[(x−ref)²], e.g. a halted instrument ticking a
    constant — get zero correlation everywhere including the diagonal,
    as the reference gives them."""
    m = float(max(int(st.count), 1))
    mu = st.s1 / m
    ms = torch.clamp(torch.diagonal(st.s2) / m, min=0.0)   # E[x²]
    cov = st.s2 / m - torch.outer(mu, mu)
    var = torch.clamp(torch.diagonal(cov), min=0.0)
    good = var > 1e-6 * torch.clamp(ms, min=1e-30)         # non-degenerate
    denom = torch.sqrt(torch.outer(var, var)) + 1e-12
    corr = torch.clamp(cov / denom, -1.0, 1.0)
    corr = torch.where(torch.outer(good, good), corr, 0.0)
    corr.diagonal().copy_(torch.where(good, 1.0, 0.0))
    return corr.to(torch.float32)


def window_delta(st: WindowState, S_prev, S_now=None) -> float:
    """mean |S_now − S_prev| — the similarity delta the warm-start cache
    thresholds on (DESIGN.md §10.3).  ``S_now`` defaults to the state's
    current similarity."""
    if S_now is None:
        S_now = window_similarity(st)
    a = torch.as_tensor(S_now).to(st.device, torch.float32)
    b = torch.as_tensor(S_prev).to(st.device, torch.float32)
    return float((a - b).abs().mean())


def materialize(st: WindowState) -> np.ndarray:
    """The window as an (n, count) array in arrival order (host-side;
    validation only — the O(n²) path never calls this)."""
    buf = st.buf.cpu().numpy()
    head, count = int(st.head), int(st.count)
    L = buf.shape[1]
    ordered = np.roll(buf, -head, axis=1)
    return ordered[:, L - count:]
