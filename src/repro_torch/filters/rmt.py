"""RMT correlation cleaning — Marchenko–Pastur eigenvalue clipping
(DESIGN.md §18.2).

The port of ``repro.filters.rmt``.  A Pearson matrix estimated from an
(n, T) window has, for pure noise, its eigenvalues in the
Marchenko–Pastur bulk below λ₊ = (1 + √(n/T))².  The cleaning keeps the
eigenpairs at or above λ₊ and flattens the bulk to its mean:

    C = Σ_bulk λ̄ v vᵀ + Σ_signal λ v vᵀ,   λ̄ = mean of bulk λ

which preserves the trace and is idempotent (the bulk term is λ̄ times a
projector); the diagonal is not renormalised, as in the reference.

``torch.linalg.eigh`` (LAPACK on the CPU, cuSOLVER on the card) is not
XLA's eigensolver: the cleaned matrix agrees with the reference's within
about 1e-5, not bitwise.  The reconstruction is a full fp32 product (the
package turns TF32 off).  The fused and staged pipelines call this one
function, so they stay bitwise equal to each other.
"""

from __future__ import annotations

import torch


def bulk_edge(n: int, T) -> float:
    """The Marchenko–Pastur upper bulk edge λ₊ = (1 + √(n/T))² for an
    (n, T) observation window (q = n/T)."""
    q = n / T
    return (1.0 + q ** 0.5) ** 2


def clean(S: torch.Tensor, T: int) -> torch.Tensor:
    """Eigenvalue-clipped correlation matrix (trace-preserving,
    idempotent); ``T`` is the window length of the (n, T) series the
    similarity was estimated from."""
    n = S.shape[-1]
    lam_plus = bulk_edge(n, T)
    w, V = torch.linalg.eigh(S.float())
    bulk = w < lam_plus
    nb = bulk.sum()
    lam_avg = torch.where(bulk, w, 0.0).sum() / torch.clamp(nb, min=1)
    wc = torch.where(bulk, lam_avg, w)
    C = (V * wc[None, :]) @ V.T
    return 0.5 * (C + C.T)
