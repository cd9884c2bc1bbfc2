"""Sparse-similarity TMFG: the lazy construction on a candidate table.

The port of ``repro.approx.sparse_tmfg`` (DESIGN.md §13.3).  It is the
port's one lazy device loop (``core/tmfg.LoopProgram``) with a table-first
value source in place of the dense S.  The three ways the dense construction
touches S each get a table-first equivalent:

  * the best-uninserted lookup -- the first uninserted entry of the
    row's sorted candidate list; when the list is exhausted, the masked
    argmax over the true row, recomputed as one ``clip(Z @ Z[v])`` from
    the standardized series (or gathered from a dense S) -- counted in
    ``fallbacks``;
  * pair values S[u, w] (gains, edge weights) -- a K-wide search of row
    u's list; a miss is rescored exactly from the source and counted in
    ``pair_misses``;
  * the clique's row sums -- over (64, n) row panels scattered from the
    table, never the full matrix, with the dense build's panels and
    reduction (``core/tmfg.panel_row_sums``).

At K = n-1 every value comes from the table, and with the top-K kernel
the table holds the Pearson kernel's own values, so the construction is
bitwise the dense one on the same card.  At K < n-1 it is the a-TMFG
approximation: candidates from the table, values exact.

The result carries the per-edge weights, so the later stages need no S.

The loop is the cached program of (n, K, the exact-value source's shape,
its kind, T, device) (``core/tmfg.LoopProgram``): the table, its values
and the source are copied into the program's buffers, and the program
replays.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.tmfg import (NEG, SparseCounters,  # noqa: F401
                                   _Source, cached_program,
                                   panel_row_sums, program_device)

from .knn import TopKTable


class _TableSource(_Source):
    """Table-first values: the (n, K) table and the exact-value source
    (standardized series Z (n, L) when ``from_x``, else S (n, n) with a
    -inf diagonal)."""

    def __init__(self, topv: torch.Tensor, topi: torch.Tensor,
                 src: torch.Tensor, from_x: bool):
        self.topv = topv.float()
        self.topi = topi.long()
        self.src = src
        self.from_x = from_x
        super().__init__(topi.shape[0], topi.device)

    def _panel(self, r0: int, r1: int) -> torch.Tensor:
        P = torch.full((r1 - r0, self.n), NEG, dtype=torch.float32,
                       device=self.device)
        return P.scatter_(1, self.topi[r0:r1], self.topv[r0:r1])

    def row_sums(self) -> torch.Tensor:
        return panel_row_sums(self._panel, self.n)

    def seed_lookup(self, W: torch.Tensor) -> torch.Tensor:
        """The reference seeds maxcorr with a masked argmax over panels
        holding only the table's entries: the first uninserted entry, or
        column 0 when none is left (no fallback, not counted)."""
        best, found = self.first_uninserted(self.topi, W)
        return torch.where(found, best, 0)

    def _true_rows(self, W: torch.Tensor) -> torch.Tensor:
        if not self.from_x:
            return self.src.index_select(0, W)
        rows = torch.clamp(self.src.index_select(0, W) @ self.src.T,
                           -1.0, 1.0)
        return rows.scatter_(1, W[:, None], NEG)

    def lookup(self, W: torch.Tensor):
        best, found = self.first_uninserted(self.topi, W)
        full = self._true_rows(W).masked_fill_(self.inserted[None, :],
                                               NEG).argmax(dim=1)
        return torch.where(found, best, full), (~found).sum()

    def values(self, r: torch.Tensor, c: torch.Tensor):
        eq = self.topi[r] == c[..., None]                    # (..., K)
        pos = eq.to(torch.int32).argmax(dim=-1, keepdim=True)
        hit = eq.gather(-1, pos)[..., 0]
        tv = self.topv[r].gather(-1, pos)[..., 0]
        if self.from_x:
            fb = torch.clamp((self.src[r] * self.src[c]).sum(-1), -1.0, 1.0)
        else:
            fb = self.src[r, c]
        return torch.where(hit, tv, fb), (~hit).sum()


def sparse_lazy_tmfg(topv: torch.Tensor, topi: torch.Tensor,
                     src: torch.Tensor, *, from_x: bool,
                     stats: Optional[dict] = None):
    """Sparse lazy construction from a table (topv, topi) and the exact
    value source ``src``: the standardized series when ``from_x``, else
    the dense S.

    Returns (TMFGResult, edge_weights (3n-6,) f32, SparseCounters);
    ``stats``, if a dict, receives ``host_syncs``."""
    n, K = topi.shape
    dev = program_device(topi.device)
    shape = tuple(src.shape)

    def make_source():
        return _TableSource(
            torch.empty((n, K), dtype=torch.float32, device=dev),
            torch.empty((n, K), dtype=torch.int64, device=dev),
            torch.empty(shape, dtype=torch.float32, device=dev), from_x)

    prog = cached_program(("table", n, K, shape, from_x), dev, make_source)
    d = prog.d
    with prog.lock:
        d.topv.copy_(topv)
        d.topi.copy_(topi)
        d.src.copy_(src)
        if not from_x:
            d.src.fill_diagonal_(NEG)
        res, syncs, w, counters = prog.run()
    if stats is not None:
        stats["host_syncs"] = syncs
    return res, w, counters


def build_tmfg_sparse(table: TopKTable, *, Xn=None, S=None,
                      stats: Optional[dict] = None):
    """Sparse lazy TMFG from a candidate table plus exactly one value
    source: the standardized series ``Xn`` or the dense ``S``.  Returns
    (TMFGResult, edge_weights, SparseCounters)."""
    if (Xn is None) == (S is None):
        raise ValueError("pass exactly one of Xn= (standardized series) "
                         "or S= (dense similarity)")
    src = Xn if S is None else S
    return sparse_lazy_tmfg(table.values, table.indices, src,
                            from_x=S is None, stats=stats)
