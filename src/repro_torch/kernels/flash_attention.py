"""Flash attention on the card: the wrapper of ``csrc/flash_attention.cu``.

Replaces ``repro.kernels.flash_attention.flash_attention_pallas``, the
twin of ``repro.models.attention._flash``.  On the main path it is the
prefill attention of every decoder layer (``models/attention.py:
attention_full`` through ``ops.flash_attention``); see the source note
in ``csrc/flash_attention.cu`` for the bound and the design.  The plain
version is ``ref.flash_attention_ref``.

GQA reads KV head ``h // G`` through the (B, T, KV, hd) strides of k
and v: no copy and no repeat over the group.  q is scaled after its
cast to fp32, as the Pallas kernel does (the model's XLA path scales q
in the input type first; ROADMAP Queue 3 records the bf16 gap).
"""

from __future__ import annotations

import math

import torch

from . import _build
from ._checks import require_cuda, require_int32_range, stream_of

KERNEL = _build.Kernel("repro_flash_attention", "ppppiiiiiiiifi")

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
Q_TILE = 64          # query rows per block (kBQ in the source)
MAX_Q_TILES = 65535  # the grid's y limit


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int):
    """Raise unless q (B, Tq, H, hd), k and v (B, Tk, KV, hd) fit the
    kernel; return (B, Tq, Tk, H, KV, hd)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-d, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Tq, H, hd = q.shape
    _, Tk, KV, _ = k.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} KV "
                         f"heads")
    if hd % 8 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} must be a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    return B, Tq, Tk, H, KV, hd


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """Attention of q (B, Tq, H, hd) over k, v (B, Tk, KV, hd), causal
    and/or within a sliding window (0 = none), float32 or bfloat16;
    returns (B, Tq, H, hd) in q's dtype."""
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        require_cuda(name, t, q.dtype, 4)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if not (k.device == v.device == q.device):
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, {v.device}")
    B, Tq, Tk, H, KV, hd = check_shapes(q, k, v, int(window))
    require_int32_range(batch_heads=B * H, Tq=Tq, Tk=Tk)
    if -(-Tq // Q_TILE) > MAX_Q_TILES:
        raise ValueError(f"Tq={Tq} needs more than {MAX_Q_TILES} query tiles")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      B, Tq, Tk, H, KV, hd, int(bool(causal)), int(window),
                      1.0 / math.sqrt(hd), DTYPES[q.dtype],
                      stream=stream_of(q))
    return o
