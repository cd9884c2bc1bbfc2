"""Flash attention on the card: the wrappers of its CUDA kernels.

Replaces ``repro.kernels.flash_attention.flash_attention_pallas``, the
twin of ``repro.models.attention._flash``.  On the main path it is the
prefill attention of every decoder layer (``models/attention.py:
attention_full`` through ``ops.flash_attention``).  The plain version is
``ref.flash_attention_ref``.

The route is chosen by dtype alone, with no fallback between them:

  * bfloat16 -> ``csrc/flash_attention_wgmma.cu``: TMA-fed K/V tiles and
    QK^T and PV on the bf16 tensor cores (``wgmma``);
  * float32  -> ``csrc/flash_attention.cu``: fp32 FMAs on the CUDA cores
    (no TF32).

Each forward writes, on request (``return_lse=True``), each row's lse
beside its output for the backward.

The backward is routed by dtype and head dim (:func:`bwd_route`), again
with no fallback between its routes:

  * bfloat16 at hd <= 128 -> ``csrc/flash_attention_bwd_wgmma.cu``
    ("wgmma"): two launches, dq (which also writes each row's D) and
    dkdv, every product on the bf16 tensor cores, fed by the TMA, with
    the lse that the bf16 forward saved (``return_lse=True``);
  * bfloat16 at hd 136..256 -> ``csrc/flash_attention_bwd_wgmma_wide.cu``
    ("wgmma_wide"): the same two launches and lse, laid out for the wide
    heads (dq with one V stage beside two K stages; dkdv items of 64
    keys whose two warpgroups hold dV and dK);
  * float32 -> ``csrc/flash_attention_bwd_tf32x3.cu`` ("tf32x3"): the
    same two launches on the lse that the fp32 forward saved, every
    product on the tensor cores in split TF32 (mma.sync: each fp32 operand
    as two TF32 halves, three products, about 22 bits; no single-pass
    TF32 anywhere);
  * "cuda_core" -> ``csrc/flash_attention_bwd.cu``, only when forced
    (the A/B's old side): three launches in fp32 on the CUDA cores (each
    row's lse and D, then dK and dV per key tile, then dQ per query tile).

:func:`flash_attention_bwd_cuda` runs a route's launches and
``ops.flash_attention`` binds forward and backward to autograd.

Each launch has its own ``_build.Kernel`` and launch count; see each
source note for its bound and design.  :func:`plan` repeats the fp32
kernel's tiling (rows per block, heads of a GQA group per block,
positions per block, the copy ring, shared memory), :func:`blocks` its
launch order and :func:`key_tiles` its tile-relevance test;
:func:`flash_plan_ref` is the plain twin that walks that schedule, held
against the Pallas kernel on the CPU.  :func:`flash_wgmma_lse_ref` and
:func:`flash_bwd_wgmma_plan_ref` are the twins of the lse the bf16
forward saves and of the bf16 backward's schedule, and
:func:`flash_bwd_wide_plan_ref` that of the backward above hd 128;
:func:`flash_lse_ref` and :func:`flash_bwd_tf32x3_plan_ref` those of the
lse the fp32 forward saves and of the fp32 backward's schedule, with
:func:`tf32_split` the kernel's TF32 halves; all held against the oracle
and JAX on the CPU.  GQA reads KV head ``h // G``
through the (B, T, KV, hd) strides of k and v: no copy and no repeat
over the group.
The fp32 scores are multiplied by ``scale`` (default ``1 / sqrt(hd)``,
the Pallas kernel's); ``attention_full`` passes a q already scaled in
its own dtype with ``scale=1``, as the model's ``_flash`` scales it.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from . import _build
from ._checks import require_cuda, require_int32_range, stream_of

# (q, k, v, o, lse, B, Tq, Tk, H, KV, hd, causal, window, scale, stream),
# both kernels: the lse pointer 0 for none
KERNEL = _build.Kernel("repro_flash_attention", "pppppiiiiiiiif")
KERNEL_WGMMA = _build.Kernel("repro_flash_attention_wgmma", "pppppiiiiiiiif")
# the backward's three launches (csrc/flash_attention_bwd.cu), each with
# its pointers, then (B, Tq, Tk, H, KV, hd, causal, window, scale, bf16)
KERNEL_BWD_ROWS = _build.Kernel("repro_flash_attention_bwd_rows",
                                "ppppppiiiiiiiifi")
KERNEL_BWD_DKDV = _build.Kernel("repro_flash_attention_bwd_dkdv",
                                "ppppppppiiiiiiiifi")
KERNEL_BWD_DQ = _build.Kernel("repro_flash_attention_bwd_dq",
                              "pppppppiiiiiiiifi")
# the bf16 backward's two launches (csrc/flash_attention_bwd_wgmma.cu), each
# with its pointers, then (B, Tq, Tk, H, KV, hd, causal, window, scale)
KERNEL_BWD_WGMMA_DQ = _build.Kernel("repro_flash_attention_bwd_wgmma_dq",
                                    "ppppppppiiiiiiiif")
KERNEL_BWD_WGMMA_DKDV = _build.Kernel("repro_flash_attention_bwd_wgmma_dkdv",
                                      "ppppppppiiiiiiiif")
# the bf16 backward above hd 128 (csrc/flash_attention_bwd_wgmma_wide.cu):
# the same two launches and arguments
KERNEL_BWD_WIDE_DQ = _build.Kernel("repro_flash_attention_bwd_wide_dq",
                                   "ppppppppiiiiiiiif")
KERNEL_BWD_WIDE_DKDV = _build.Kernel("repro_flash_attention_bwd_wide_dkdv",
                                     "ppppppppiiiiiiiif")
# the fp32 backward (csrc/flash_attention_bwd_tf32x3.cu): the same two
# launches and arguments
KERNEL_BWD_TF32X3_DQ = _build.Kernel("repro_flash_attention_bwd_tf32x3_dq",
                                     "ppppppppiiiiiiiif")
KERNEL_BWD_TF32X3_DKDV = _build.Kernel(
    "repro_flash_attention_bwd_tf32x3_dkdv", "ppppppppiiiiiiiif")
# each two-launch backward route's (dq, dkdv) kernels
BWD_KERNELS = {"wgmma": (KERNEL_BWD_WGMMA_DQ, KERNEL_BWD_WGMMA_DKDV),
               "wgmma_wide": (KERNEL_BWD_WIDE_DQ, KERNEL_BWD_WIDE_DKDV),
               "tf32x3": (KERNEL_BWD_TF32X3_DQ, KERNEL_BWD_TF32X3_DKDV)}

ROUTES = {torch.float32: KERNEL, torch.bfloat16: KERNEL_WGMMA}
MAX_HEAD_DIM = 256
MAX_Q_TILES = 65535  # the grid's y limit
# the fp32 kernel's tiling (flash_attention.cu)
WARPS = 8            # warps per block (kWarps)
KEYS = 64            # keys per tile (kBK)
MAX_SMEM = 232448    # shared memory one block may use on Hopper
NEG = -1e30          # the masked score (kNeg)
# the bf16 backward (csrc/flash_attention_bwd_wgmma.cu): its largest head
# dim, rows per consumer warpgroup (kRows: a dq item holds two, 128
# queries; a dkdv item 128 keys), keys per K/V tile of dq (kBK) and
# queries per Q/dO tile of dkdv (kBQ); the saved lse and D have
# LSE_ALIGN-rounded rows (lse_rows in csrc/flash_wgmma.cuh)
BWD_WGMMA_MAX_HEAD_DIM = 128
BWD_WGMMA_ROWS = 64
BWD_WGMMA_KEYS = 64
BWD_WGMMA_QUERIES = 64
LSE_ALIGN = 64
# the bf16 backward above hd 128 (csrc/flash_attention_bwd_wgmma_wide.cu):
# dq as above (kRows, kBK), dkdv items of BWD_WIDE_KEYS keys (kBK) walking
# BWD_WIDE_QUERIES-query tiles (kBQ)
BWD_WIDE_KEYS = 64
BWD_WIDE_QUERIES = 64
# the bf16 forward's tiles (csrc/flash_attention_wgmma.cu): 128 query
# rows per item, 128 keys per tile up to hd 128 and 64 above
WGMMA_QUERIES = 128
# the fp32 backward (csrc/flash_attention_bwd_tf32x3.cu): rows of a work
# item (queries of dq, keys of dkdv) and of each streamed tile, up to
# TF32X3_WIDE_HEAD_DIM and above it
TF32X3_ROWS = 64
TF32X3_WIDE_ROWS = 32
TF32X3_WIDE_HEAD_DIM = 128


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
    return _flash_plan(q, k, v, causal=causal, window=window, scale=scale,
                       positions=positions, heads=heads, keys=keys)[0]


def _flash_plan(q, k, v, *, causal, window, scale, positions=None,
                heads=None, keys=None):
    """:func:`flash_plan_ref`'s walk: (out in q's dtype, the lse the
    kernel saves, (B, H, lse_rows(Tq)) fp32)."""
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
    lse = torch.full((B, H, lse_rows(Tq)), float("inf"), device=q.device)
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
        row = torch.where(m > NEG, m + torch.log(l), float("inf"))
        lse[b, h0:h0 + heads, q_lo:q_lo + n_pos] = \
            row.reshape(heads, positions)[:, :n_pos]
    return out.to(q.dtype), lse


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


def lse_rows(Tq: int) -> int:
    """Rows of the saved lse and D per (b, h): Tq rounded up to LSE_ALIGN
    (the padding rows hold lse = +inf and D = 0)."""
    return -(-Tq // LSE_ALIGN) * LSE_ALIGN


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         scale: Optional[float] = None,
                         return_lse: bool = False):
    """Attention of q (B, Tq, H, hd) over k, v (B, Tk, KV, hd), causal
    and/or within a sliding window (0 = none), float32 or bfloat16, the
    scores times ``scale`` (None: 1 / sqrt(hd)); returns (B, Tq, H, hd)
    in q's dtype.  ``return_lse`` (for the backward): returns (o, lse)
    with lse (B, H, lse_rows(Tq)) fp32, each row's natural-log
    logsumexp of its scaled scores over its live keys (+inf for a row
    with none, and on the padding rows); o is the same bit for bit as
    without it."""
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
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr()]
    lse = None
    if return_lse:
        lse = torch.empty((B, H, lse_rows(Tq)), dtype=torch.float32,
                          device=q.device)
    ptrs.append(0 if lse is None else lse.data_ptr())
    with torch.cuda.device(q.device):
        kernel.launch(*ptrs, B, Tq, Tk, H, KV, hd, int(bool(causal)),
                      int(window),
                      1.0 / math.sqrt(hd) if scale is None else float(scale),
                      stream=stream_of(q))
    return (o, lse) if return_lse else o


def bwd_route(dtype: torch.dtype, hd: int) -> str:
    """The backward that takes inputs of ``dtype`` at head dim ``hd``:
    "wgmma" (``flash_attention_bwd_wgmma.cu``) for bfloat16 up to hd 128,
    "wgmma_wide" (``flash_attention_bwd_wgmma_wide.cu``) for bfloat16
    above it, "tf32x3" (``flash_attention_bwd_tf32x3.cu``) for float32 at
    every hd.  The CUDA-core backward ("cuda_core") is no route: it runs
    only when :func:`bwd_launches` is asked for it."""
    if dtype not in ROUTES:
        raise TypeError(f"q must be float32 or bfloat16, got {dtype}")
    if dtype == torch.float32:
        return "tf32x3"
    return "wgmma" if hd <= BWD_WGMMA_MAX_HEAD_DIM else "wgmma_wide"


def bwd_launches(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                 window: int = 0, scale: Optional[float] = None,
                 lse: Optional[torch.Tensor] = None,
                 route: Optional[str] = None):
    """The backward's outputs and its launches, unlaunched: ((dq, dk,
    dv), [(name, launch)]) with ``launch()`` running one kernel on the
    current stream.  ``route`` None takes :func:`bwd_route`'s;
    "cuda_core" forces the CUDA-core backward at any dtype and head dim (for an
    A/B on the card).  On the "cuda_core" route: rows (lse and D into
    fp32 scratch), dkdv, dq.  On the "wgmma", "wgmma_wide" and "tf32x3"
    routes: dq (which writes D) and dkdv, reading ``lse`` as
    ``flash_attention_cuda(..., return_lse=True)`` gave it; where ``lse``
    is None, a first launch ("lse") runs that forward into scratch for
    it.  Raises on inputs the kernels do not take."""
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
    route = route or bwd_route(q.dtype, hd)
    if route != "cuda_core" and route != bwd_route(q.dtype, hd):
        raise ValueError(f"no {route!r} backward for {q.dtype} at hd {hd}")
    if lse is not None and route == "cuda_core":
        raise ValueError("the CUDA-core backward computes its own lse")
    sizes = (B, Tq, Tk, H, KV, hd, int(bool(causal)), int(window),
             1.0 / math.sqrt(hd) if scale is None else float(scale))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    f32 = dict(dtype=torch.float32, device=q.device)
    s = stream_of(q)

    def launcher(kernel, *args):
        def launch():
            with torch.cuda.device(q.device):
                kernel.launch(*(a.data_ptr() if isinstance(a, torch.Tensor)
                                else a for a in args), stream=s)
        return launch

    if route == "cuda_core":
        if -(-max(Tq, Tk) // 32) > MAX_Q_TILES:
            raise ValueError(f"T={max(Tq, Tk)} needs more than "
                             f"{MAX_Q_TILES} tiles")
        lse = torch.empty((B, H, Tq), **f32)
        D = torch.empty((B, H, Tq), **f32)
        sizes += (int(q.dtype == torch.bfloat16),)
        return (dq, dk, dv), [
            ("rows", launcher(KERNEL_BWD_ROWS, q, k, o, do, lse, D, *sizes)),
            ("dkdv", launcher(KERNEL_BWD_DKDV, q, k, v, do, lse, D, dk, dv,
                              *sizes)),
            ("dq", launcher(KERNEL_BWD_DQ, q, k, v, do, lse, D, dq,
                            *sizes))]
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if route == "tf32x3" and -(-max(Tq, Tk) // TF32X3_WIDE_ROWS) > MAX_Q_TILES:
        raise ValueError(f"T={max(Tq, Tk)} needs more than {MAX_Q_TILES} "
                         f"tiles")
    rows = (B, H, lse_rows(Tq))
    launches = []
    if lse is None:
        lse = torch.empty(rows, **f32)
        launches.append(("lse", launcher(kernel_for(q.dtype), q, k, v,
                                         torch.empty_like(q), lse, *sizes)))
    elif (lse.dtype != torch.float32 or tuple(lse.shape) != rows
          or lse.device != q.device or not lse.is_contiguous()
          or lse.data_ptr() % 16):
        raise ValueError(f"lse must be a contiguous, 16-byte aligned "
                         f"float32 {rows} on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    D = torch.empty(rows, **f32)
    k_dq, k_dkdv = BWD_KERNELS[route]
    return (dq, dk, dv), launches + [
        ("dq", launcher(k_dq, q, k, v, o, do, lse, D, dq, *sizes)),
        ("dkdv", launcher(k_dkdv, q, k, v, do, lse, D, dk, dv, *sizes))]


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, *, causal: bool = True,
                             window: int = 0,
                             scale: Optional[float] = None,
                             lse: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of ``flash_attention_cuda(q, k, v, ...)`` whose output
    was ``o``, given the output's gradient ``do``: q, o, do (B, Tq, H,
    hd) and k, v (B, Tk, KV, hd), all float32 or all bfloat16, on the
    card.  The launches of :func:`bwd_launches` on the current stream
    (``lse``: the forward's, from ``return_lse=True``); the gradients
    come back in the inputs' dtype.  The plain twin is
    ``ref.flash_attention_bwd_ref``."""
    grads, launches = bwd_launches(q, k, v, o, do, causal=causal,
                                   window=window, scale=scale, lse=lse)
    for _, launch in launches:
        launch()
    return grads


# ---- plain twins of the bf16 kernels' schedules (CPU tests) -----------------

def _live(t0: int, nt: int, j0: int, nj: int, Tq: int, Tk: int,
          causal: bool, window: int) -> torch.Tensor:
    """(nt, nj): whether query t0 + i and key j0 + j are a live pair."""
    ti = torch.arange(t0, t0 + nt)[:, None]
    ji = torch.arange(j0, j0 + nj)[None, :]
    ok = (ti < Tq) & (ji < Tk)
    if causal:
        ok &= ji <= ti
    if window > 0:
        ok &= ti - ji < window
    return ok


def _padded(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, T, heads, hd) in fp32, zero rows past T up to n (the TMA's
    out-of-bounds zeros)."""
    out = torch.zeros((x.shape[0], n) + tuple(x.shape[2:]))
    out[:, :x.shape[1]] = x.float()
    return out


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest even), kept in fp32."""
    return x.to(torch.bfloat16).float()


def wgmma_keys(hd: int) -> int:
    """Keys per K/V tile of the bf16 forward at head dim ``hd``."""
    return 128 if hd <= 128 else 64


def flash_wgmma_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The plain twin of the lse the bf16 forward saves: each query tile
    of WGMMA_QUERIES rows walks its key tiles ``key_tiles`` keeps, with
    the scores in log2 units (times scale * log2 e), masked to NEG, the
    running max m and sum l of 2^(x - m); lse = (m + log2 l) ln 2, +inf
    where m stayed NEG (no live key) and on the padding rows.  Returns
    (B, H, lse_rows(Tq)) fp32."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    keys, rows = wgmma_keys(hd), WGMMA_QUERIES
    mul = (1.0 / math.sqrt(hd) if scale is None else scale) * math.log2(math.e)
    nk = -(-Tk // keys)
    qp, kp = _padded(q, -(-Tq // rows) * rows), _padded(k, nk * keys)
    lse = torch.full((B, H, lse_rows(Tq)), float("inf"))
    for b in range(B):
        for h in range(H):
            for q_lo in range(0, Tq, rows):
                m = torch.full((rows,), NEG)
                l = torch.zeros(rows)
                lo, hi = key_tiles(q_lo, rows, Tk, causal, window, keys)
                for kt in range(lo, hi):
                    x = (qp[b, q_lo:q_lo + rows, h]
                         @ kp[b, kt * keys:(kt + 1) * keys, h // G].T) * mul
                    x = torch.where(_live(q_lo, rows, kt * keys, keys, Tq,
                                          Tk, causal, window), x, NEG)
                    m_new = torch.maximum(m, x.amax(1))
                    l = l * torch.exp2(m - m_new) + torch.exp2(
                        x - m_new[:, None]).sum(1)
                    m = m_new
                n = min(rows, Tq - q_lo)
                lse[b, h, q_lo:q_lo + n] = torch.where(
                    m > NEG, (m + torch.log2(l)) * math.log(2.0),
                    float("inf"))[:n]
    return lse


def flash_bwd_wgmma_plan_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, *, causal: bool = True,
                             window: int = 0, scale: Optional[float] = None,
                             lse: Optional[torch.Tensor] = None,
                             keys: Optional[int] = None,
                             queries: Optional[int] = None):
    """The plain twin of the bf16 backward's schedule
    (``csrc/flash_attention_bwd_wgmma.cu``): (a) dq over the items of
    2 x BWD_WGMMA_ROWS queries, each warpgroup's rows walking the key
    tiles ``key_tiles`` keeps (skipping a tile with no live pair for its
    rows), D = rowsum(dO o) in fp32, P = 2^(s scale log2 e - lse log2 e)
    on live pairs, dS = P (dP - D) rounded to bf16 for dQ += dS K; (b)
    dkdv over the items of 2 x BWD_WGMMA_ROWS keys, each warpgroup's keys
    walking the G heads and the query tiles that can see the item, P^T
    and dS^T rounded to bf16 for dV += P^T dO and dK += dS^T Q.  ``lse``
    defaults to :func:`flash_wgmma_lse_ref`'s.  Returns (dq, dk, dv) in
    q's dtype.  ``keys`` (dq's K/V tile) and ``queries`` (dkdv's Q/dO
    tile) default to the kernel's and may be set smaller to walk many
    tiles at a small shape."""
    return _bwd_plan_ref(q, k, v, o, do, causal=causal, window=window,
                         scale=scale, lse=lse,
                         keys=keys or BWD_WGMMA_KEYS,
                         queries=queries or BWD_WGMMA_QUERIES,
                         key_item=2 * BWD_WGMMA_ROWS,
                         key_part=BWD_WGMMA_ROWS)


def flash_bwd_wide_plan_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, *, causal: bool = True,
                            window: int = 0, scale: Optional[float] = None,
                            lse: Optional[torch.Tensor] = None,
                            keys: Optional[int] = None,
                            queries: Optional[int] = None):
    """The plain twin of the bf16 backward above hd 128
    (``csrc/flash_attention_bwd_wgmma_wide.cu``): (a) dq as in
    :func:`flash_bwd_wgmma_plan_ref` (items of 2 x BWD_WGMMA_ROWS
    queries, BWD_WIDE_KEYS-key tiles; the kernel's K and V rings change
    no sum); (b) dkdv over items of BWD_WIDE_KEYS keys, walking the G
    heads and the BWD_WIDE_QUERIES-query tiles that can see the item
    (skipping a tile with no live pair): P^T formed in fp32 from the lse
    (warpgroup 0), dS^T = P^T (dP^T - D) from that fp32 P^T (warpgroup
    1), each rounded to bf16 for dV += P^T dO and dK += dS^T Q over the
    whole head dim.  Returns (dq, dk, dv) in q's dtype; ``keys`` and
    ``queries`` as in :func:`flash_bwd_wgmma_plan_ref`."""
    return _bwd_plan_ref(q, k, v, o, do, causal=causal, window=window,
                         scale=scale, lse=lse, keys=keys or BWD_WIDE_KEYS,
                         queries=queries or BWD_WIDE_QUERIES,
                         key_item=BWD_WIDE_KEYS, key_part=BWD_WIDE_KEYS)


def _bwd_plan_ref(q, k, v, o, do, *, causal, window, scale, lse, keys,
                  queries, key_item, key_part):
    """The two bf16 backwards' shared schedule: dq items of
    2 x BWD_WGMMA_ROWS queries over ``keys``-key tiles; dkdv items of
    ``key_item`` keys, each part of ``key_part`` keys (one warpgroup's
    rows) walking ``queries``-query tiles."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    R, tile = BWD_WGMMA_ROWS, 2 * BWD_WGMMA_ROWS
    mul = 1.0 / math.sqrt(hd) if scale is None else scale
    log2e = math.log2(math.e)
    if lse is None:
        lse = flash_wgmma_lse_ref(q, k, causal=causal, window=window,
                                  scale=scale)
    lse2 = lse.float() * log2e                         # (B, H, rows)
    nq, nk = -(-Tq // tile), -(-Tk // key_item)
    qp = _padded(q, max(nq * tile, lse2.shape[2]))
    dop = _padded(do, qp.shape[1])
    op = _padded(o, qp.shape[1])
    kp = _padded(k, max(nk * key_item, -(-Tk // keys) * keys))
    vp = _padded(v, kp.shape[1])
    live = functools.partial(_live, Tq=Tq, Tk=Tk, causal=causal,
                             window=window)
    D = (dop * op).sum(-1)                             # (B, T, H)

    def p_ds(b, h, t0, nt, j0, nj):
        """P and dS of queries [t0, t0 + nt) and keys [j0, j0 + nj)."""
        s = qp[b, t0:t0 + nt, h] @ kp[b, j0:j0 + nj, h // G].T
        rows = torch.arange(t0, t0 + nt)
        m = torch.where(rows < lse2.shape[2],
                        lse2[b, h, rows.clamp(max=lse2.shape[2] - 1)],
                        float("inf"))
        p = torch.where(live(t0, nt, j0, nj),
                        torch.exp2(s * (mul * log2e) - m[:, None]), 0.0)
        dp = dop[b, t0:t0 + nt, h] @ vp[b, j0:j0 + nj, h // G].T
        return p, p * (dp - D[b, t0:t0 + nt, h][:, None])

    def any_live(t0, nt, j0, nj):
        return bool(live(t0, nt, j0, nj).any())

    # (a) dq
    dq = torch.zeros((B, qp.shape[1], H, hd))
    for b, h, q_lo in ((b, h, (nq - 1 - i) * tile)
                       for i in range(nq) for b in range(B)
                       for h in range(H)):
        lo, hi = key_tiles(q_lo, tile, Tk, causal, window, keys)
        for qa in (q_lo, q_lo + R):
            for kt in range(lo, hi):
                if not any_live(qa, R, kt * keys, keys):
                    continue
                _, ds = p_ds(b, h, qa, R, kt * keys, keys)
                dq[b, qa:qa + R, h] += \
                    _bf16(ds) @ kp[b, kt * keys:(kt + 1) * keys, h // G]
    # (b) dkdv
    dk = torch.zeros((B, nk * key_item, KV, hd))
    dv = torch.zeros_like(dk)
    for i in range(nk * B * KV):
        b, kvh = i % (B * KV) // KV, i % KV
        k_lo = i // (B * KV) * key_item
        t_lo = k_lo if causal else 0
        t_hi = min(Tq, k_lo + key_item - 1 + window) if window > 0 else Tq
        tiles = range(t_lo // queries, -(-t_hi // queries)) \
            if t_lo < t_hi else range(0)
        for kw in range(k_lo, k_lo + key_item, key_part):
            for h in range(kvh * G, (kvh + 1) * G):
                for qt in tiles:
                    t0 = qt * queries
                    if not any_live(t0, queries, kw, key_part):
                        continue
                    p, ds = p_ds(b, h, t0, queries, kw, key_part)
                    dv[b, kw:kw + key_part, kvh] += \
                        _bf16(p).T @ dop[b, t0:t0 + queries, h]
                    dk[b, kw:kw + key_part, kvh] += \
                        _bf16(ds).T @ qp[b, t0:t0 + queries, h]
    return ((dq[:, :Tq] * mul).to(q.dtype), (dk[:, :Tk] * mul).to(k.dtype),
            dv[:, :Tk].to(v.dtype))


# ---- plain twins of the fp32 kernels (CPU tests) ------------------------------

def flash_lse_ref(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                  window: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """The plain twin of the lse the fp32 forward saves: each block of
    :func:`blocks` walks its key tiles as :func:`flash_plan_ref` does (q
    times scale, scores masked to NEG, the running max m and sum l of
    exp(s - m)); lse = m + log l, +inf where m stayed NEG (no live key)
    and on the padding rows.  Returns (B, H, lse_rows(Tq)) fp32."""
    return _flash_plan(q, k, k, causal=causal, window=window,
                       scale=scale)[1]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: x (fp32) rounded to 10 mantissa bits, to
    nearest with ties away from zero, through int32 bit operations (the
    low 13 bits of the magnitude rounded and cleared), kept in fp32."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    bits = ((bits & 0xFFFFFFFF) + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fp32 backward's split of an operand into TF32 halves: hi =
    rna(x), lo = rna(x - hi) (x - hi is exact in fp32), so that
    |x - hi - lo| <= 2^-22 |x|."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def tf32x3_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the fp32 backward's tensor-core products form it: lo(a)
    hi(b) + hi(a) lo(b) + hi(a) hi(b), each in fp32 (lo lo dropped)."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return al @ bh + ah @ bl + ah @ bh


def tf32x3_rows(hd: int) -> int:
    """Rows of a work item and of a streamed tile of the fp32 backward."""
    return TF32X3_ROWS if hd <= TF32X3_WIDE_HEAD_DIM else TF32X3_WIDE_ROWS


def flash_bwd_tf32x3_plan_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, *, causal: bool = True,
                              window: int = 0,
                              scale: Optional[float] = None,
                              lse: Optional[torch.Tensor] = None,
                              rows: Optional[int] = None):
    """The plain twin of the fp32 backward's schedule
    (``csrc/flash_attention_bwd_tf32x3.cu``), every product through
    :func:`tf32x3_mm`: (a) dq over (b, h, query tile) items, heaviest
    causal tile first, walking the key tiles ``key_tiles`` keeps
    (skipping a tile with no live pair): S = Q K^T, P = 2^(S scale
    log2 e - lse log2 e) on live pairs, dP = dO V^T, dS = P (dP - D)
    with D = rowsum(dO o), dQ += dS K; (b) dkdv over (b, KV head, key
    tile) items, walking the G heads and the query tiles that can see
    the item: S^T = K Q^T and P^T, dP^T = V dO^T, dS^T = P^T (dP^T - D),
    dV += P^T dO and dK += dS^T Q.  ``lse`` defaults to
    :func:`flash_lse_ref`'s.  Returns (dq, dk, dv) in fp32.  ``rows``
    (the items' and tiles' rows) defaults to the kernel's
    (:func:`tf32x3_rows`) and may be set smaller to walk many tiles at a
    small shape."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    R = rows or tf32x3_rows(hd)
    mul = 1.0 / math.sqrt(hd) if scale is None else scale
    log2e = math.log2(math.e)
    if lse is None:
        lse = flash_lse_ref(q, k, causal=causal, window=window, scale=scale)
    nq, nk = -(-Tq // R), -(-Tk // R)
    ldr = lse.shape[2]
    lse2 = torch.full((B, H, nq * R), float("inf"))
    lse2[..., :min(ldr, nq * R)] = lse[..., :nq * R].float()
    lse2 = lse2 * log2e
    qp, dop, op = (_padded(x, nq * R) for x in (q, do, o))
    kp, vp = _padded(k, nk * R), _padded(v, nk * R)
    live = functools.partial(_live, Tq=Tq, Tk=Tk, causal=causal,
                             window=window)
    D = (dop * op).sum(-1)                             # (B, T, H)
    sl = torch.tensor(mul * log2e, dtype=torch.float32)

    def p_tile(s, t0, j0, b, h):
        """P of queries [t0, t0 + R) (rows of s) and keys [j0, j0 + R)."""
        m = lse2[b, h, t0:t0 + R][:, None]
        return torch.where(live(t0, R, j0, R), torch.exp2(s * sl - m), 0.0)

    # (a) dq
    dq = torch.zeros((B, nq * R, H, hd))
    for i in range(nq):
        q_lo = (nq - 1 - i) * R
        for b in range(B):
            for h in range(H):
                lo, hi = key_tiles(q_lo, R, Tk, causal, window, R)
                for kt in range(lo, hi):
                    j0 = kt * R
                    if not bool(live(q_lo, R, j0, R).any()):
                        continue
                    kt_ = kp[b, j0:j0 + R, h // G]
                    s = tf32x3_mm(qp[b, q_lo:q_lo + R, h], kt_.T)
                    p = p_tile(s, q_lo, j0, b, h)
                    dp = tf32x3_mm(dop[b, q_lo:q_lo + R, h],
                                   vp[b, j0:j0 + R, h // G].T)
                    ds = p * (dp - D[b, q_lo:q_lo + R, h][:, None])
                    dq[b, q_lo:q_lo + R, h] += tf32x3_mm(ds, kt_)
    # (b) dkdv
    dk = torch.zeros((B, nk * R, KV, hd))
    dv = torch.zeros_like(dk)
    for kt in range(nk):
        k_lo = kt * R
        t_lo = k_lo if causal else 0
        t_hi = min(Tq, k_lo + R - 1 + window) if window > 0 else Tq
        tiles = range(t_lo // R, -(-t_hi // R)) if t_lo < t_hi else range(0)
        for b in range(B):
            for kvh in range(KV):
                kk = kp[b, k_lo:k_lo + R, kvh]
                vv = vp[b, k_lo:k_lo + R, kvh]
                for h in range(kvh * G, (kvh + 1) * G):
                    for qt in tiles:
                        t0 = qt * R
                        if not bool(live(t0, R, k_lo, R).any()):
                            continue
                        qq, dd = qp[b, t0:t0 + R, h], dop[b, t0:t0 + R, h]
                        pt = p_tile(tf32x3_mm(kk, qq.T).T, t0, k_lo, b,
                                    h).T
                        dpt = tf32x3_mm(vv, dd.T)
                        dst = pt * (dpt - D[b, t0:t0 + R, h][None, :])
                        dv[b, k_lo:k_lo + R, kvh] += tf32x3_mm(pt, dd)
                        dk[b, k_lo:k_lo + R, kvh] += tf32x3_mm(dst, qq)
    return dq[:, :Tq] * mul, dk[:, :Tk] * mul, dv[:, :Tk]
