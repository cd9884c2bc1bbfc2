"""Top-K Pearson candidate tables (DESIGN.md §13.2).

The port of ``repro.approx.knn``.  The tables the sparse TMFG consumes:

  * :func:`topk_pearson` -- straight from the series through ``ops.topk``
    (``csrc/topk.cu`` on the card), never holding (n, n);
  * :func:`topk_from_similarity` -- cut from a dense S by a stable
    descending sort, for callers that already hold S;
  * :func:`rescore_pools` -- exact Pearson rescoring of candidate pools
    (``project.candidate_pools``), row panel by row panel.

Each orders a row by value descending, then index ascending
(``lax.top_k``'s order), and never lists the diagonal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import standardize_rows

NEG = float("-inf")

# elements of one (rows, n) sort buffer in topk_from_similarity
_SORT_ELEMS = 1 << 26


class TopKTable(NamedTuple):
    """Per-row candidate table: ``values[i, j]`` is the Pearson
    correlation of rows i and ``indices[i, j]``."""

    values: torch.Tensor   # (n, K) f32
    indices: torch.Tensor  # (n, K) i32


def topk_pearson(X: torch.Tensor, k: int, *,
                 backend: str = "auto") -> TopKTable:
    """Exact top-k Pearson candidates of each row of X (n, L); k is
    clamped to n - 1 (every off-diagonal partner)."""
    X = X.float()
    k = min(int(k), X.shape[0] - 1)
    v, i = ops.topk(X, k, backend=backend)
    return TopKTable(values=v, indices=i)


def topk_pearson_and_z(X: torch.Tensor, k: int, *, backend: str = "auto"):
    """(TopKTable, standardized Z): the table and the exact-value source
    of the sparse build's fallbacks."""
    X = X.float()
    return topk_pearson(X, k, backend=backend), standardize_rows(X)


def topk_from_similarity(S: torch.Tensor, k: int) -> TopKTable:
    """The table cut from a dense (n, n) S: the first k of a stable
    descending sort of each row with the diagonal at -inf (``lax.top_k``
    on the same matrix), in row chunks."""
    n = S.shape[0]
    k = min(int(k), n - 1)
    chunk = max(1, _SORT_ELEMS // max(n, 1))
    vals, idxs = [], []
    for r0 in range(0, n, chunk):
        rows = S[r0:r0 + chunk].to(torch.float32, copy=True)
        ar = torch.arange(rows.shape[0], device=S.device)
        rows[ar, ar + r0] = NEG
        v, i = torch.sort(rows, dim=1, descending=True, stable=True)
        vals.append(v[:, :k].contiguous())
        idxs.append(i[:, :k].int())
    return TopKTable(values=torch.cat(vals), indices=torch.cat(idxs))


def rescore_pools(X, pools, k: int) -> TopKTable:
    """Exact Pearson rescoring of candidate pools ``pools (n, P)`` (P >= k,
    e.g. from ``project.candidate_pools``): each pool rescored with true
    Pearson dots, the row itself dropped, reduced to its top-k in the
    table's (value desc, index asc) order — a sort by candidate index,
    then a stable sort by value.  k is clamped to P and n - 1.  The
    (rows, P, L) gathers run in row panels of at most ``_SORT_ELEMS``
    elements.  The batched dots may round a pair differently from
    ``topk_pearson``'s by about an ulp, so the two tables agree exactly
    only where values are well separated, as in the reference."""
    X = torch.as_tensor(X).float()
    pools = torch.as_tensor(pools, device=X.device).long()
    n, P = pools.shape
    k = min(int(k), P, X.shape[0] - 1)
    Z = standardize_rows(X)
    L = Z.shape[1]
    chunk = max(1, _SORT_ELEMS // max(P * L, 1))
    vals, idxs = [], []
    for r0 in range(0, n, chunk):
        p = pools[r0:r0 + chunk]
        s = torch.bmm(Z[r0:r0 + chunk, None, :],
                      Z[p].transpose(1, 2)).squeeze(1)
        s = torch.clamp(s, -1.0, 1.0)
        own = torch.arange(r0, r0 + p.shape[0], device=X.device)[:, None]
        s = s.masked_fill(p == own, NEG)                  # drop self
        p, by_index = torch.sort(p, dim=1, stable=True)
        v, by_value = torch.sort(s.gather(1, by_index), dim=1,
                                 descending=True, stable=True)
        vals.append(v[:, :k].contiguous())
        idxs.append(p.gather(1, by_value[:, :k]).int())
    return TopKTable(values=torch.cat(vals), indices=torch.cat(idxs))


FLOOR = -2.0  # finite fill below the Pearson range [-1, 1]


def densify(table: TopKTable, *, n: int) -> torch.Tensor:
    """The table as a dense (n, n) matrix, FLOOR where a pair (or the
    diagonal) is missing, as the reference's ``densify``."""
    out = torch.full((n, n), FLOOR, dtype=torch.float32,
                     device=table.values.device)
    return out.scatter_(1, table.indices.long(), table.values.float())
