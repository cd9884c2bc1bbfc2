"""Seeded random graphs with the degree shape of a TMFG.

A TMFG is an Apollonian network: it starts from a 4-clique and inserts
each further vertex into one triangular face, joining it to the face's
three corners.  Its hubs (the first vertices, and the vertices that
faces keep choosing) reach degrees far above the mean of about 6, which
is what a kernel that walks one vertex's edges at a time must survive.
:func:`apollonian_edges` draws the face uniformly at random, so it has
that degree shape without the similarity data behind a real TMFG.  The
timing tools and ``chip_smoke.py`` run the sparse relaxation on it; it
is numpy only.
"""

from __future__ import annotations

import numpy as np


def apollonian_edges(n: int, seed: int = 0) -> np.ndarray:
    """Edges (3n - 6, 2) int32 of a random Apollonian network on n >= 4
    vertices: a 4-clique, then each vertex inserted into a face chosen
    uniformly at random, then the labels permuted.  Each row is (lo, hi);
    the rows are sorted."""
    if n < 4:
        raise ValueError(f"an Apollonian network needs n >= 4, got {n}")
    rng = np.random.default_rng(seed)
    faces = np.empty((2 * n - 4, 3), dtype=np.int64)
    faces[:4] = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))
    edges = np.empty((3 * n - 6, 2), dtype=np.int64)
    edges[:6] = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
    picks = rng.random(n)
    nf, ne = 4, 6
    for v in range(4, n):
        f = int(picks[v] * nf)
        a, b, c = faces[f]
        edges[ne:ne + 3] = ((a, v), (b, v), (c, v))
        faces[f] = (a, b, v)
        faces[nf] = (a, c, v)
        faces[nf + 1] = (b, c, v)
        nf, ne = nf + 2, ne + 3
    perm = rng.permutation(n)
    e = perm[edges]
    e = np.sort(e, axis=1)
    e = e[np.lexsort((e[:, 1], e[:, 0]))]
    return e.astype(np.int32)
