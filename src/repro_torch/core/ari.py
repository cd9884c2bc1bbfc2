"""Adjusted Rand Index — the paper's clustering-quality metric (§5, eq. 1).

A copy of ``repro.core.ari`` (numpy only; the port never imports
``repro``)."""

from __future__ import annotations

import numpy as np


def _comb2(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float64)
    return x * (x - 1.0) / 2.0


def ari(labels_true, labels_pred) -> float:
    """Adjusted Rand Index (Hubert & Arabie 1985). 1 = perfect, ~0 = random."""
    a = np.asarray(labels_true).ravel()
    b = np.asarray(labels_pred).ravel()
    assert a.shape == b.shape
    n = a.size
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    ka, kb = ai.max() + 1, bi.max() + 1
    cont = np.zeros((ka, kb), dtype=np.int64)
    np.add.at(cont, (ai, bi), 1)

    sum_ij = _comb2(cont).sum()
    sum_i = _comb2(cont.sum(axis=1)).sum()
    sum_j = _comb2(cont.sum(axis=0)).sum()
    total = _comb2(np.array(n))
    expected = sum_i * sum_j / total if total > 0 else 0.0
    max_index = 0.5 * (sum_i + sum_j)
    denom = max_index - expected
    if denom == 0:
        return 1.0 if sum_ij == max_index else 0.0
    return float((sum_ij - expected) / denom)
