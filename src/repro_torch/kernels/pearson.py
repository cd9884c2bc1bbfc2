"""Pearson correlation on the card: the wrapper of ``csrc/pearson.cu``.

Replaces ``repro.kernels.pearson.pearson_pallas``.  As there, the row
statistics (mean and inverse norm) are computed outside the kernel, here
in PyTorch, and the kernel standardises each tile as it loads it, so the
standardised matrix never exists in device memory.  See the source note
in ``csrc/pearson.cu`` for the bound and the design.
"""

from __future__ import annotations

import torch

from . import _build
from ._checks import require_cuda, require_int32_range, stream_of

KERNEL = _build.Kernel("repro_pearson", "ppppii")


def row_stats(X: torch.Tensor, eps: float = 1e-12):
    """(mean, 1 / (norm + eps)) of every centred row, as the JAX wrapper
    computes them before its ``pallas_call``."""
    mu = X.mean(dim=1, keepdim=True)
    ss = torch.sum((X - mu) ** 2, dim=1, keepdim=True)
    rs = 1.0 / (torch.sqrt(ss) + eps)
    return mu.reshape(-1).contiguous(), rs.reshape(-1).contiguous()


def pearson_cuda(X: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Pearson correlation of the rows of X (n, L) f32 -> (n, n) f32."""
    require_cuda("X", X, torch.float32, 2)
    n, L = X.shape
    require_int32_range(n=n, L=L, nL=n * L)
    mu, rs = row_stats(X, eps)
    out = torch.empty((n, n), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        KERNEL.launch(X.data_ptr(), mu.data_ptr(), rs.data_ptr(),
                      out.data_ptr(), n, L, stream=stream_of(X))
    return out
