"""Masked row argmax on the card: the wrapper of ``csrc/masked_argmax.cu``.

Replaces ``repro.kernels.gainscan.masked_argmax_pallas``.  On the main
path it is the complete-linkage merge scan (``core/hac.py``), launched
n - 1 times per clustering; see the source note in
``csrc/masked_argmax.cu`` for the bound and the design.  The result is
bitwise the plain ``ref.masked_argmax_ref``'s, fully masked rows
included.
"""

from __future__ import annotations

import torch

from . import _build
from ._checks import require_cuda, require_int32_range, stream_of

KERNEL = _build.Kernel("repro_masked_argmax", "ppppii")


def masked_argmax_cuda(S: torch.Tensor, mask: torch.Tensor):
    """Per-row (max, argmax) of S (m, n) f32 with True columns of mask (n,)
    excluded.  Returns (values (m,) f32, indices (m,) int32)."""
    require_cuda("S", S, torch.float32, 2)
    require_cuda("mask", mask, torch.bool, 1)
    m, n = S.shape
    if mask.shape[0] != n or mask.device != S.device:
        raise ValueError(f"mask {tuple(mask.shape)} on {mask.device} does "
                         f"not fit S {tuple(S.shape)} on {S.device}")
    require_int32_range(m=m, n=n)
    vals = torch.empty((m,), dtype=torch.float32, device=S.device)
    idx = torch.empty((m,), dtype=torch.int32, device=S.device)
    with torch.cuda.device(S.device):
        KERNEL.launch(S.data_ptr(), mask.data_ptr(), vals.data_ptr(),
                      idx.data_ptr(), m, n, stream=stream_of(S))
    return vals, idx
