"""Maximum spanning tree by Borůvka rounds on the device (DESIGN.md §18.1).

The port of ``repro.filters.mst``.  Each round, on the device:

  1. per-row maxima of the component-masked similarity, a plain max
     reduction over (rows, n) panels (not the gain-scan kernel, as in the
     reference); its first-maximum index gives the lowest column that
     reaches the maximum;
  2. per-component best outgoing edge by (max weight, then lowest
     canonical edge id min(u, v) * n + max(u, v)) — a global total order
     on edges, so the pick graph has only mutual 2-cycles and the union
     of the picks is acyclic.  For a fixed row the canonical id grows
     with the column, so a row's lowest canonical id among its maxima is
     that of its first maximum;
  3. hook the higher root under the lower (a scatter-min with a trash
     slot for the rows that pick nothing), emit this round's applied
     picks into the (n-1, 2) buffer exactly where the reference does,
     and compress by ⌈log₂ n⌉ pointer jumps (``p[p]`` is idempotent at
     the fixed point, so no host read is needed).

The loop reads one flag a round (components left), about ⌈log₂ n⌉
rounds.  Canonical ids are int64, so any n fits.
"""

from __future__ import annotations

import math

import torch

from .graph import FilterGraph

NEG = float("-inf")

# elements of one (rows, n) panel of the per-row maxima
PANEL_ELEMS = 1 << 26


def _row_max(S: torch.Tensor, comp: torch.Tensor):
    """(max, first argmax) of each row of S with the row's own component
    masked to -inf, panel by panel."""
    n = S.shape[0]
    vals = torch.empty(n, dtype=torch.float32, device=S.device)
    idx = torch.empty(n, dtype=torch.int64, device=S.device)
    rows = max(1, PANEL_ELEMS // max(n, 1))
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        M = S[r0:r1].masked_fill(comp[r0:r1, None] == comp[None, :], NEG)
        torch.max(M, dim=1, out=(vals[r0:r1], idx[r0:r1]))
    return vals, idx


def build_mst(S: torch.Tensor, *, backend: str = "auto",
              stats: dict = None) -> FilterGraph:
    """Maximum spanning tree of a finite symmetric similarity matrix:
    exactly n-1 canonical edges, in the reference's emission order.

    ``backend`` is accepted for the reference's signature (the rounds are
    plain PyTorch on every backend).  ``stats``, if a dict, receives
    ``mst_rounds``."""
    S = S.float()
    n = S.shape[0]
    dev = S.device
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    sent = n * n
    comp = rows.clone()
    edges = torch.zeros((n, 2), dtype=torch.int64, device=dev)  # + trash
    offset = torch.zeros((), dtype=torch.int64, device=dev)
    jumps = max(1, math.ceil(math.log2(max(n, 2))))
    i = 0
    while i < n and int((comp == rows).sum()) > 1:   # one read a round
        vals, idx = _row_max(S, comp)
        best = torch.full((n,), NEG, device=dev).scatter_reduce_(
            0, comp, vals, "amax")
        canon = torch.minimum(rows, idx) * n + torch.maximum(rows, idx)
        row_min = torch.where(vals == best[comp], canon, sent)
        emin = torch.full((n,), sent, dtype=torch.int64,
                          device=dev).scatter_reduce_(0, comp, row_min,
                                                      "amin")
        ok = emin < sent
        a = torch.clamp(emin // n, 0, n - 1)
        b = torch.clamp(emin % n, 0, n - 1)
        ca, cb = comp[a], comp[b]
        lo = torch.minimum(ca, cb)
        hi = torch.where(ok, torch.maximum(ca, cb), n)
        ptr = torch.arange(n + 1, dtype=torch.int64, device=dev)
        ptr.scatter_reduce_(0, hi, lo, "amin")
        ptr = ptr[:n]
        keep = (ok & (ptr[torch.clamp(hi, max=n - 1)] == lo)
                & ((rows == lo) | (emin[lo] != emin)))
        pos = torch.where(keep, offset + torch.cumsum(keep, 0) - 1, n - 1)
        edges.index_copy_(0, pos, torch.stack([a, b], dim=1))
        for _ in range(jumps):
            ptr = ptr[ptr]
        comp = ptr[comp]
        offset = offset + keep.sum()
        i += 1
    if stats is not None:
        stats["mst_rounds"] = i
    e = edges[:n - 1].to(torch.int32)
    w = S[edges[:n - 1, 0], edges[:n - 1, 1]]
    return FilterGraph(edges=e, weights=w, edge_sum=w.sum())
