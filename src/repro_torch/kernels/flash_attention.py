"""Flash attention on the card: the wrappers of two CUDA kernels.

Replaces ``repro.kernels.flash_attention.flash_attention_pallas``, the
twin of ``repro.models.attention._flash``.  On the main path it is the
prefill attention of every decoder layer (``models/attention.py:
attention_full`` through ``ops.flash_attention``).  The plain version is
``ref.flash_attention_ref``.

The route is chosen by dtype alone, with no fallback between them:

  * bfloat16 -> ``csrc/flash_attention_wgmma.cu``: TMA-fed K/V tiles and
    QK^T and PV on the bf16 tensor cores (``wgmma``);
  * float32  -> ``csrc/flash_attention.cu``: fp32 FMAs on the CUDA cores
    (the port keeps fp32 off the tensor cores: no TF32).

Each has its own ``_build.Kernel`` and launch count; see each source
note for its bound and design.  GQA reads KV head ``h // G`` through the
(B, T, KV, hd) strides of k and v: no copy and no repeat over the group.
The fp32 scores are multiplied by ``scale`` (default ``1 / sqrt(hd)``,
the Pallas kernel's); ``attention_full`` passes a q already scaled in
its own dtype with ``scale=1``, as the model's ``_flash`` scales it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from ._checks import require_cuda, require_int32_range, stream_of

# (q, k, v, o, B, Tq, Tk, H, KV, hd, causal, window, scale, stream)
KERNEL = _build.Kernel("repro_flash_attention", "ppppiiiiiiiif")
KERNEL_WGMMA = _build.Kernel("repro_flash_attention_wgmma", "ppppiiiiiiiif")

ROUTES = {torch.float32: KERNEL, torch.bfloat16: KERNEL_WGMMA}
MAX_HEAD_DIM = 256
Q_TILE = 64          # query rows per block of the fp32 kernel (kBQ)
MAX_Q_TILES = 65535  # the grid's y limit


def kernel_for(dtype: torch.dtype) -> _build.Kernel:
    """The kernel that takes q, k, v of ``dtype``."""
    try:
        return ROUTES[dtype]
    except KeyError:
        raise TypeError(f"q must be float32 or bfloat16, got {dtype}") \
            from None


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int):
    """Raise unless q (B, Tq, H, hd), k and v (B, Tk, KV, hd) fit the
    kernels; return (B, Tq, Tk, H, KV, hd)."""
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
                         *, causal: bool = True, window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q (B, Tq, H, hd) over k, v (B, Tk, KV, hd), causal
    and/or within a sliding window (0 = none), float32 or bfloat16, the
    scores times ``scale`` (None: 1 / sqrt(hd)); returns (B, Tq, H, hd)
    in q's dtype."""
    kernel = kernel_for(q.dtype)
    for name, t in (("q", q), ("k", k), ("v", v)):
        require_cuda(name, t, q.dtype, 4)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if not (k.device == v.device == q.device):
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, {v.device}")
    B, Tq, Tk, H, KV, hd = check_shapes(q, k, v, int(window))
    require_int32_range(batch_heads=B * H, Tq=Tq, Tk=Tk)
    if kernel is KERNEL and -(-Tq // Q_TILE) > MAX_Q_TILES:
        # the fp32 kernel's grid has a y axis of query tiles; the wgmma
        # kernel's grid is one block per SM
        raise ValueError(f"Tq={Tq} needs more than {MAX_Q_TILES} query tiles")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      B, Tq, Tk, H, KV, hd, int(bool(causal)), int(window),
                      1.0 / math.sqrt(hd) if scale is None else float(scale),
                      stream=stream_of(q))
    return o
