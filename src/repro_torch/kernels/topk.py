"""Streaming top-K Pearson on the card: the wrapper of ``csrc/topk.cu``.

Replaces ``repro.kernels.topk.topk_pearson_pallas``.  Like the Pearson
wrapper, it computes the row statistics (mean and inverse norm) in
PyTorch and the kernel standardises each tile as it loads it, with
``csrc/pearson.cu``'s arithmetic, so every value is bitwise the entry of
``pearson_cuda(X)`` and the (n, n) matrix never exists.  See the source
note in ``csrc/topk.cu`` for the bound and the design.
"""

from __future__ import annotations

import torch

from . import _build
from ._checks import require_cuda, require_int32_range, stream_of
from .pearson import row_stats

KERNEL = _build.Kernel("repro_topk", "ppppppiiiiiii")

# dynamic shared memory one block may use on Hopper (227 KB)
MAX_SMEM = 232448
_TILE = 64                       # columns per tile (kBN in topk.cu)
_CHUNK = 128                     # series elements per chunk, at most
_SCRATCH_ROWS = 8                # rows per block with buffers in device memory


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def plan(n: int, L: int, k: int):
    """(rows per block, buffer capacity, chunk length, shared bytes,
    whether the buffers go to device memory) for the kernel.

    The series is streamed in chunks of at most 128 elements, so shared
    memory does not depend on L.  The most rows per block whose candidate
    buffers fit in shared memory, each of min(2k, n-1) + 64 slots rounded
    up to a power of two, else k + 64; where not even 4 rows fit (k above
    about 4000), 8 rows per block with the first capacity in device
    memory."""
    Lc = min((L + 3) // 4 * 4, _CHUNK)
    caps = (_next_pow2(min(2 * k, n - 1) + _TILE), _next_pow2(k + _TILE))
    for rows in (64, 32, 16, 8, 4):
        for cap in caps:
            smem = 4 * (rows * Lc + Lc * _TILE + 2 * rows * cap + 3 * rows)
            if smem <= MAX_SMEM:
                return rows, cap, Lc, smem, False
    rows = _SCRATCH_ROWS
    return rows, caps[0], Lc, 4 * (rows * Lc + Lc * _TILE + 3 * rows), True


def topk_pearson_cuda(X: torch.Tensor, k: int, eps: float = 1e-12):
    """Top-k Pearson partners of each row of X (n, L) f32, the diagonal
    excluded: (values (n, k) f32, indices (n, k) int32), ordered by value
    descending, then index ascending."""
    require_cuda("X", X, torch.float32, 2)
    n, L = X.shape
    if not 1 <= k <= n - 1:
        raise ValueError(f"need 1 <= k <= n-1, got k={k} for n={n}")
    require_int32_range(n=n, L=L, nL=n * L, nk=n * k)
    rows, cap, Lc, smem, in_memory = plan(n, L, k)
    mu, rs = row_stats(X, eps)
    vals = torch.empty((n, k), dtype=torch.float32, device=X.device)
    idx = torch.empty((n, k), dtype=torch.int32, device=X.device)
    scratch = None
    if in_memory:
        blocks = (n + rows - 1) // rows
        scratch = torch.empty(blocks * 2 * rows * cap, dtype=torch.float32,
                              device=X.device)
    with torch.cuda.device(X.device):
        KERNEL.launch(X.data_ptr(), mu.data_ptr(), rs.data_ptr(),
                      vals.data_ptr(), idx.data_ptr(),
                      0 if scratch is None else scratch.data_ptr(),
                      n, L, k, rows, cap, Lc, smem, stream=stream_of(X))
    return vals, idx
