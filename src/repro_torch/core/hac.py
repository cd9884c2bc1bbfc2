"""Complete-linkage hierarchical agglomerative clustering.

The port of ``repro.core.hac`` (DESIGN.md §4.2, §11.3).  Each of the n-1
merges finds the closest alive pair and replaces the merged row and
column by their elementwise maximum (complete linkage).  The loop makes
no host sync: the merge indices stay 0-d device tensors (shape (1,) here,
so every step is an ``index_select``/``index_copy_`` and never a Python
integer), and the linkage matrix is written on the device.

Two forms of the per-merge scan, bitwise the same linkage:

  * ``backend="torch"`` — the reference's flat form (its ``"jnp"``): one
    argmin over the alive-masked (n, n) matrix;
  * ``"auto"``/``"cuda"`` — the masked-argmax form: a per-row (max,
    argmax) of ``-D`` with dead columns masked
    (``kernels.ops.masked_argmax``, the CUDA kernel on the card), then an
    argmax over alive rows.

The masked form keeps ``N = -D`` for the whole run instead of negating D
on every merge (which would write a second (n, n) matrix per merge); the
merge becomes ``minimum(N[i], N[j])``.  Negation is exact, so every
compared value, and so the linkage, is the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops

INF = float("inf")


def complete_linkage(D: torch.Tensor, *, backend: str = "torch") -> torch.Tensor:
    """Complete-linkage HAC on a dense distance matrix.

    Returns a scipy-style linkage matrix (n-1, 4) float32 on D's device:
    (left id, right id, height, size); leaf ids < n, merge k creates id
    n+k.  Ties break to the lowest flat index.
    """
    n = D.shape[0]
    dev = D.device
    masked_form = backend != "torch"
    if masked_form:
        # N = -D, diagonal -inf: one (n, n) buffer for the whole run
        M = torch.neg(D.float())
        M.fill_diagonal_(-INF)
    else:
        M = D.to(torch.float32, copy=True)
        M.fill_diagonal_(INF)
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    sizes = torch.ones(n, dtype=torch.int64, device=dev)
    dead = torch.zeros(n, dtype=torch.bool, device=dev)
    Z = torch.zeros((n - 1, 4), dtype=torch.float32, device=dev)

    for k in range(n - 1):
        if masked_form:
            vals, idx = ops.masked_argmax(M, dead, backend=backend)
            vals = vals.masked_fill(dead, -INF)
            i = vals.argmax().view(1)
            j = idx.index_select(0, i).long()
            h = -vals.index_select(0, i)
        else:
            alive = ~dead
            big = torch.where(alive[:, None] & alive[None, :], M, INF)
            flat = big.argmin().view(1)
            i, j = flat // n, flat % n
            h = big.view(-1).index_select(0, flat)
        lo, hi = torch.minimum(i, j), torch.maximum(i, j)
        size = sizes.index_select(0, lo) + sizes.index_select(0, hi)
        Z[k] = torch.cat([ids.index_select(0, lo).float(),
                          ids.index_select(0, hi).float(), h, size.float()])
        # complete linkage: the merged row/column is the elementwise max
        # of D (the min of N = -D), written in place into row and column lo
        if masked_form:
            row = torch.minimum(M.index_select(0, lo), M.index_select(0, hi))
        else:
            row = torch.maximum(M.index_select(0, lo), M.index_select(0, hi))
        M.index_copy_(0, lo, row)
        M.index_copy_(1, lo, row.view(n, 1))
        M.view(-1).index_fill_(0, lo * n + lo, -INF if masked_form else INF)
        dead.index_fill_(0, hi, True)
        ids.index_fill_(0, lo, n + k)
        sizes.index_copy_(0, lo, size)
    return Z


def hierarchical_offsets(D: torch.Tensor, bubble_of: torch.Tensor,
                         cluster_of: torch.Tensor) -> torch.Tensor:
    """Adjusted distances whose single-run complete linkage equals the
    three-level (intra-bubble, intra-cluster, inter-cluster) nested HAC
    (DESIGN.md §4.2): cross-bubble pairs get +M1, cross-cluster pairs a
    further +(M2-M1), with M1 = 2 dmax and M2 = 8 dmax."""
    fin = torch.isfinite(D)
    dmax = torch.where(fin, D, 0.0).max() + 1.0
    m1 = 2.0 * dmax
    m2 = 8.0 * dmax
    adj = torch.where(fin, D, dmax)  # disconnected -> far
    del fin
    cross = bubble_of[:, None] != bubble_of[None, :]
    adj.add_(torch.where(cross, m1, 0.0))
    cross = cluster_of[:, None] != cluster_of[None, :]
    adj.add_(torch.where(cross, m2 - m1, 0.0))
    return adj


def cut_linkage(Z, n: int, k: int) -> np.ndarray:
    """Cut a linkage matrix into k flat clusters (numpy host op, a copy of
    the reference's)."""
    if isinstance(Z, torch.Tensor):
        Z = Z.cpu().numpy()
    Z = np.asarray(Z)
    k = int(max(1, min(k, n)))
    parent = np.arange(n + len(Z))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    order = np.argsort(Z[:, 2], kind="stable")
    clusters = n
    for idx in order:
        if clusters <= k:
            break
        a, b = int(Z[idx, 0]), int(Z[idx, 1])
        new = n + int(idx)
        parent[find(a)] = new
        parent[find(b)] = new
        clusters -= 1
    roots, labels = {}, np.zeros(n, dtype=np.int64)
    for v in range(n):
        r = find(v)
        labels[v] = roots.setdefault(r, len(roots))
    return labels
