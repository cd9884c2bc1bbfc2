"""Seeded random-projection sketches → per-row candidate pools
(DESIGN.md §13.1).

The port of ``repro.approx.project``.  Pearson correlation of
standardised rows is a cosine, and a Johnson–Lindenstrauss projection of
``X (n, L)`` to ``(n, dim)`` keeps cosines to about 1/sqrt(dim), so the
top-``pool`` partners of each row in the sketch (``ops.topk`` on the
sketch: ``csrc/topk.cu`` on the card) are candidates that
``knn.rescore_pools`` then rescores with exact Pearson dots.

The projection matrix R (L, dim) is drawn by :func:`projection` from a
CPU ``torch.Generator`` seeded with ``seed`` and then moved to X's
device, so one seed gives one R, and the same pools, on the CPU and on
the card.  JAX's ``PRNGKey`` stream is not reproduced: the port's R is
not the reference's (the tests carry the reference's R across in place
of :func:`projection`'s).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import standardize_rows


def projection(L: int, dim: int, seed: int) -> torch.Tensor:
    """The (L, dim) N(0, 1/dim) projection matrix of ``seed``, on the
    CPU."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    return torch.randn(L, dim, generator=gen,
                       dtype=torch.float32) / math.sqrt(dim)


def sketch(X: torch.Tensor, *, dim: int = 64, seed: int = 0) -> torch.Tensor:
    """(n, L) → (n, dim) seeded Gaussian random-projection sketch of the
    standardised rows (so it approximates Pearson, not raw cosine)."""
    X = torch.as_tensor(X).float()
    Z = standardize_rows(X)
    R = projection(X.shape[1], dim, seed).to(X.device)
    return Z @ R


def candidate_pools(X: torch.Tensor, pool: int, *, dim: int = 64,
                    seed: int = 0, backend: str = "auto") -> torch.Tensor:
    """Per-row candidate pools from the sketch: (n, pool) int32 indices,
    the sketch-similarity top-``pool`` of each row (``pool`` clamped to
    n - 1), ordered by value descending then index ascending, never the
    row itself."""
    s = sketch(X, dim=dim, seed=seed)
    pool = min(int(pool), s.shape[0] - 1)
    _, idx = ops.topk(s, pool, backend=backend)
    return idx
