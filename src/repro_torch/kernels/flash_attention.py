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

The backward, ``csrc/flash_attention_bwd.cu``, takes both dtypes and
computes in fp32 on the CUDA cores: three launches (each row's lse and
D, then dK and dV per key tile, then dQ per query tile), each with its
own ``_build.Kernel``; :func:`flash_attention_bwd_cuda` runs them and
``ops.flash_attention`` binds it to autograd.

Each has its own ``_build.Kernel`` and launch count; see each source
note for its bound and design.  :func:`plan` repeats the fp32 kernel's
tiling (rows per block, heads of a GQA group per block, positions per
block, the copy ring, shared memory), :func:`blocks` its launch order
and :func:`key_tiles` its tile-relevance test; :func:`flash_plan_ref` is
the plain twin that walks that schedule, held against the Pallas kernel
on the CPU.  GQA reads KV head ``h // G`` through the
(B, T, KV, hd) strides of k and v: no copy and no repeat over the group.
The fp32 scores are multiplied by ``scale`` (default ``1 / sqrt(hd)``,
the Pallas kernel's); ``attention_full`` passes a q already scaled in
its own dtype with ``scale=1``, as the model's ``_flash`` scales it.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from . import _build
from ._checks import require_cuda, require_int32_range, stream_of

# (q, k, v, o, B, Tq, Tk, H, KV, hd, causal, window, scale, stream)
KERNEL = _build.Kernel("repro_flash_attention", "ppppiiiiiiiif")
KERNEL_WGMMA = _build.Kernel("repro_flash_attention_wgmma", "ppppiiiiiiiif")
# the backward's three launches (csrc/flash_attention_bwd.cu), each with
# its pointers, then (B, Tq, Tk, H, KV, hd, causal, window, scale, bf16)
KERNEL_BWD_ROWS = _build.Kernel("repro_flash_attention_bwd_rows",
                                "ppppppiiiiiiiifi")
KERNEL_BWD_DKDV = _build.Kernel("repro_flash_attention_bwd_dkdv",
                                "ppppppppiiiiiiiifi")
KERNEL_BWD_DQ = _build.Kernel("repro_flash_attention_bwd_dq",
                              "pppppppiiiiiiiifi")

ROUTES = {torch.float32: KERNEL, torch.bfloat16: KERNEL_WGMMA}
MAX_HEAD_DIM = 256
MAX_Q_TILES = 65535  # the grid's y limit
# the fp32 kernel's tiling (flash_attention.cu)
WARPS = 8            # warps per block (kWarps)
KEYS = 64            # keys per tile (kBK)
MAX_SMEM = 232448    # shared memory one block may use on Hopper
NEG = -1e30          # the masked score (kNeg)


class FlashPlan(NamedTuple):
    ng: int          # float4 output column groups per lane
    rows: int        # query rows per block: heads x positions
    positions: int   # positions per block
    heads: int       # heads of one GQA group per block
    keys: int        # keys per tile
    stages: int      # K/V tiles' halves in the copy ring (1: one buffer)
    grid: Tuple[int, int]
    smem: int        # dynamic shared memory per block


def plan(B: int, Tq: int, H: int, KV: int, hd: int) -> FlashPlan:
    """The fp32 kernel's launch, with ``flash_attention.cu``'s formulas.
    Up to hd 128: 4 query rows per lane in 8 warps (128 a block), two
    heads of a group over 64 positions where the group size is even, else
    one head over 128; 64-key tiles in a 3-slot K/V ring.  Above hd 128
    (``flash_kernel_wide``): 64 rows of one head, 4 rows per thread of a
    16 x 16 grid, K and V taking turns in one 64-key buffer."""
    if hd <= 128:
        ng = 1 if hd <= 32 else 2 if hd <= 64 else 4
        rows, stages, p_stride = 4 * 4 * WARPS, 3, KEYS + 8
        positions = rows // 2 if (H // KV) % 2 == 0 else rows
    else:
        ng = -(-hd // 64)
        rows, stages, p_stride = 64, 1, KEYS + 4
        positions = rows
    heads = rows // positions
    smem = 4 * ((rows + stages * KEYS) * (hd + 4) + rows * p_stride)
    return FlashPlan(ng, rows, positions, heads, KEYS, stages,
                     (B * H // heads, -(-Tq // positions)), smem)


def key_tiles(q_lo: int, positions: int, Tk: int, causal: bool,
              window: int, keys: int) -> Tuple[int, int]:
    """[lo, hi): the key tiles a block of positions [q_lo, q_lo +
    positions) walks, by the Pallas kernel's relevance test."""
    hi = -(-Tk // keys)
    if causal:
        hi = min(hi, (q_lo + positions - 1) // keys + 1)
    lo = max(0, (q_lo - window + 1) // keys) if window > 0 else 0
    return lo, hi


def blocks(B: int, Tq: int, H: int, KV: int, positions: int,
           heads: int) -> List[Tuple[int, int, int]]:
    """The (batch, first head, first position) of every block, in launch
    order: the last positions (the heaviest causal tiles) first, then
    batch, KV head and head pair within each."""
    G = H // KV
    out = []
    for by in range(-(-Tq // positions)):
        q_lo = (-(-Tq // positions) - 1 - by) * positions
        for bx in range(B * H // heads):
            hc, bk = bx % (G // heads), bx // (G // heads)
            out.append((bk // KV, (bk % KV) * G + hc * heads, q_lo))
    return out


def flash_plan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   scale: Optional[float] = None,
                   positions: Optional[int] = None,
                   heads: Optional[int] = None,
                   keys: Optional[int] = None) -> torch.Tensor:
    """The plain twin of the fp32 kernel's schedule: every block of
    ``blocks`` gathers its heads x positions rows (q times ``scale`` in
    fp32, rows past Tq zero), walks its key tiles [lo, hi) with K and V
    zero past Tk, masks with the finite NEG, and keeps the running max,
    denominator and accumulator of the online softmax; the output is
    acc / max(l, 1e-30).  ``positions``, ``heads`` and ``keys`` default
    to the kernel's plan and may be set smaller to walk many tiles at a
    small shape."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    pl = plan(B, Tq, H, KV, hd)
    positions = positions or pl.positions
    heads = heads or pl.heads
    keys = keys or pl.keys
    G = H // KV
    if G % heads:
        raise ValueError(f"{heads} heads per block do not divide G={G}")
    mul = torch.tensor(1.0 / math.sqrt(hd) if scale is None else scale,
                       dtype=torch.float32)
    nk = -(-Tk // keys)
    Tqp = -(-Tq // positions) * positions
    qs = torch.zeros((B, Tqp, H, hd), dtype=torch.float32, device=q.device)
    qs[:, :Tq] = q.float() * mul
    kp = torch.zeros((B, nk * keys, KV, hd), dtype=torch.float32,
                     device=q.device)
    vp = torch.zeros_like(kp)
    kp[:, :Tk], vp[:, :Tk] = k.float(), v.float()
    out = torch.empty((B, Tq, H, hd), dtype=torch.float32, device=q.device)
    for b, h0, q_lo in blocks(B, Tq, H, KV, positions, heads):
        kvh = h0 // G
        qi = torch.arange(q_lo, q_lo + positions, device=q.device)
        rows = qs[b, q_lo:q_lo + positions, h0:h0 + heads]   # (P, Gb, hd)
        rows = rows.transpose(0, 1).reshape(heads * positions, hd)
        qi = qi.repeat(heads)
        m = torch.full((rows.shape[0], 1), NEG, device=q.device)
        l = torch.zeros((rows.shape[0], 1), device=q.device)
        acc = torch.zeros((rows.shape[0], hd), device=q.device)
        lo, hi = key_tiles(q_lo, positions, Tk, causal, window, keys)
        for kt in range(lo, hi):
            ki = torch.arange(kt * keys, (kt + 1) * keys, device=q.device)
            s = rows @ kp[b, kt * keys:(kt + 1) * keys, kvh].T
            live = ki[None, :] < Tk
            if causal:
                live = live & (qi[:, None] >= ki[None, :])
            if window > 0:
                live = live & (qi[:, None] - ki[None, :] < window)
            s = torch.where(live, s, torch.tensor(NEG))
            m_new = torch.maximum(m, s.amax(1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(1, keepdim=True)
            acc = acc * corr + p @ vp[b, kt * keys:(kt + 1) * keys, kvh]
            m = m_new
        o = (acc / l.clamp_min(1e-30)).reshape(heads, positions, hd)
        n_pos = min(positions, Tq - q_lo)
        out[b, q_lo:q_lo + n_pos, h0:h0 + heads] = \
            o.transpose(0, 1)[:n_pos]
    return out.to(q.dtype)


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
    if kernel is KERNEL and plan(B, Tq, H, KV, hd).grid[1] > MAX_Q_TILES:
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


def bwd_launches(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                 window: int = 0, scale: Optional[float] = None):
    """The backward's outputs and its three launches, unlaunched: ((dq,
    dk, dv), [(name, launch)]) with ``launch()`` running one kernel on
    the current stream, in order rows (lse and D into fp32 scratch),
    dkdv, dq.  Raises on inputs the kernels do not take."""
    if q.dtype not in ROUTES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        require_cuda(name, t, q.dtype, 4)
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
    B, Tq, Tk, H, KV, hd = check_shapes(q, k, v, int(window))
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"be q's shape {tuple(q.shape)}")
    require_int32_range(batch_heads=B * H, Tq=Tq, Tk=Tk)
    if -(-max(Tq, Tk) // 32) > MAX_Q_TILES:
        raise ValueError(f"T={max(Tq, Tk)} needs more than {MAX_Q_TILES} "
                         f"tiles")
    f32 = dict(dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, Tq), **f32)
    D = torch.empty((B, H, Tq), **f32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    sizes = (B, Tq, Tk, H, KV, hd, int(bool(causal)), int(window),
             1.0 / math.sqrt(hd) if scale is None else float(scale),
             int(q.dtype == torch.bfloat16))
    p = [t.data_ptr() for t in (q, k, v, o, do, lse, D, dq, dk, dv)]
    s = stream_of(q)

    def launcher(kernel, *ptrs):
        def launch():
            with torch.cuda.device(q.device):
                kernel.launch(*ptrs, *sizes, stream=s)
        return launch

    return (dq, dk, dv), [
        ("rows", launcher(KERNEL_BWD_ROWS, p[0], p[1], p[3], p[4], p[5],
                          p[6])),
        ("dkdv", launcher(KERNEL_BWD_DKDV, p[0], p[1], p[2], p[4], p[5],
                          p[6], p[8], p[9])),
        ("dq", launcher(KERNEL_BWD_DQ, p[0], p[1], p[2], p[4], p[5], p[6],
                        p[7]))]


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, *, causal: bool = True,
                             window: int = 0,
                             scale: Optional[float] = None):
    """(dq, dk, dv) of ``flash_attention_cuda(q, k, v, ...)`` whose output
    was ``o``, given the output's gradient ``do``: q, o, do (B, Tq, H,
    hd) and k, v (B, Tk, KV, hd), all float32 or all bfloat16, on the
    card.  Three launches on the current stream (the rows' lse and D in
    fp32 scratch, then dK and dV, then dQ); the gradients come back in
    the inputs' dtype.  The plain twin is ``ref.flash_attention_bwd_ref``."""
    grads, launches = bwd_launches(q, k, v, o, do, causal=causal,
                                   window=window, scale=scale)
    for _, launch in launches:
        launch()
    return grads
