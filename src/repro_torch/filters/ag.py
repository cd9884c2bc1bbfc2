"""Asset Graph — global top-m edge threshold (DESIGN.md §18.1).

The port of ``repro.filters.ag``: keep the m globally strongest pairs of
the upper triangle, with no topological constraint (so the graph may be
disconnected; the §18.4 tail's components stage handles that).

The reference takes one ``lax.top_k`` over the n(n-1)/2 upper-triangle
values, which orders the picks by value descending and breaks ties by
ascending flat position.  ``torch.topk`` promises no tie order, so the
port takes only the m-th largest value t from it, then picks every
entry above t and the first entries equal to t in row-major order (the
upper triangle's flat order is row-major), and orders the picks by a
stable descending sort of their values over ascending positions.  It
works on the (n, n) matrix with the lower triangle and the diagonal at
-inf, so no (n(n-1)/2,) index pair arrays are formed; (i, j) come back
only for the m picks.
"""

from __future__ import annotations

import torch

from .graph import FilterGraph

NEG = float("-inf")


def ag_edge_count(n: int, ag_m: int = 0) -> int:
    """The AG edge budget: ``ag_m`` when positive, else the TMFG's 3n-6,
    clamped to the n(n-1)/2 pairs that exist."""
    m = ag_m if ag_m > 0 else max(3 * n - 6, 1)
    return max(1, min(m, n * (n - 1) // 2))


def build_ag(S: torch.Tensor, *, m: int) -> FilterGraph:
    """Top-m asset graph of a symmetric similarity matrix: exactly m
    canonical edges in descending-similarity order, ties by ascending
    (i, j) — bitwise the reference's ``lax.top_k`` pick."""
    n = S.shape[0]
    M = torch.triu(S.float(), diagonal=1)
    M.masked_fill_(torch.ones(n, n, dtype=torch.bool,
                              device=S.device).tril_(), NEG)
    flat = M.view(-1)
    t = torch.topk(flat, m, sorted=False).values.min()
    above = torch.nonzero(flat > t).view(-1)
    at = torch.nonzero(flat == t).view(-1)
    at = at[(at % n) > (at // n)]          # the upper triangle only
    pos = torch.cat([above, at[:m - above.numel()]]).sort().values
    v, order = torch.sort(flat[pos], descending=True, stable=True)
    pos = pos[order]
    edges = torch.stack([pos // n, pos % n], dim=1).to(torch.int32)
    return FilterGraph(edges=edges, weights=v, edge_sum=v.sum())
