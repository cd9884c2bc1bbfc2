"""Min-plus product on the card: the wrapper of ``csrc/minplus.cu``.

Replaces ``repro.kernels.minplus.minplus_pallas``; see the source note in
``csrc/minplus.cu`` for the bound and the design.  The result is bitwise
the plain ``ref.minplus_ref``'s.
"""

from __future__ import annotations

import torch

from . import _build
from ._checks import require_cuda, require_int32_range, stream_of

KERNEL = _build.Kernel("repro_minplus", "pppiii")


def minplus_cuda(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """out[i,j] = min_k A[i,k] + B[k,j] for contiguous f32 A (m, k), B (k, n).

    Writes a fresh (m, n) tensor; never writes into A or B."""
    require_cuda("A", A, torch.float32, 2)
    require_cuda("B", B, torch.float32, 2)
    m, k = A.shape
    k2, n = B.shape
    if k != k2 or A.device != B.device:
        raise ValueError(f"minplus: A {tuple(A.shape)} on {A.device} and "
                         f"B {tuple(B.shape)} on {B.device} do not chain")
    require_int32_range(m=m, k=k, n=n)
    out = torch.empty((m, n), dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        KERNEL.launch(A.data_ptr(), B.data_ptr(), out.data_ptr(), m, k, n,
                      stream=stream_of(A))
    return out
