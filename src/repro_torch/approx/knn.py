"""Top-K Pearson candidate tables (DESIGN.md §13.2).

The port of ``repro.approx.knn`` without ``rescore_pools`` (ROADMAP
Queue 1 item 7).  The tables the sparse TMFG consumes:

  * :func:`topk_pearson` -- straight from the series through ``ops.topk``
    (``csrc/topk.cu`` on the card), never holding (n, n);
  * :func:`topk_from_similarity` -- cut from a dense S by a stable
    descending sort, for callers that already hold S.

Both order each row by value descending, then index ascending
(``lax.top_k``'s order), and never list the diagonal.
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


FLOOR = -2.0  # finite fill below the Pearson range [-1, 1]


def densify(table: TopKTable, *, n: int) -> torch.Tensor:
    """The table as a dense (n, n) matrix, FLOOR where a pair (or the
    diagonal) is missing, as the reference's ``densify``."""
    out = torch.full((n, n), FLOOR, dtype=torch.float32,
                     device=table.values.device)
    return out.scatter_(1, table.indices.long(), table.values.float())
