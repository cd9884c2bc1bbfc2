"""Backend dispatch for the port's kernels.

Backends (``PipelineConfig.backend``):
  * ``"cuda"``  — the hand-written CUDA kernel; raises for a CPU tensor.
  * ``"torch"`` — the plain PyTorch version (``ref.py``) on the tensor's
    own device.
  * ``"auto"``  — the kernel for a tensor on the card, the plain version
    for a tensor on the CPU (mirroring ``repro.kernels.ops._resolve``,
    which picks Pallas on a TPU and jnp elsewhere).

A failed build or launch raises; nothing falls back to the plain
version.  On the card, attention that autograd must differentiate goes
through :class:`FlashAttentionFn`, whose backward is the hand-written
backward kernel; everything else runs without autograd's bookkeeping.

Each entry point charges its call to the cost walker
(``launch/cost.py``) by its kernel's formula (``charges.py``), on both
routes, and the walker counts nothing inside it.  While a walk is on,
differentiable plain attention goes through :class:`FlashAttentionFn`
with the plain forward and backward in the kernels' places, so that its
backward is charged as the kernel's is, and attention on tensors without
data (meta, fake) gives outputs of its shape only.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import charges, gainscan, minplus as minplus_mod
from . import pearson as pearson_mod, ref
from . import flash_attention as flash_mod
from . import sparse_apsp as sparse_mod, topk as topk_mod

BACKENDS = ("auto", "cuda", "torch")

# name -> the kernel's _build.Kernel (its symbol and launch count)
KERNELS = {
    "pearson": pearson_mod.KERNEL,
    "minplus": minplus_mod.KERNEL,
    "masked_argmax": gainscan.KERNEL,
    "topk": topk_mod.KERNEL,
    "sparse_relax": sparse_mod.KERNEL,
    "flash_attention": flash_mod.KERNEL,
    "flash_attention_wgmma": flash_mod.KERNEL_WGMMA,
    "flash_attention_bwd_rows": flash_mod.KERNEL_BWD_ROWS,
    "flash_attention_bwd_dkdv": flash_mod.KERNEL_BWD_DKDV,
    "flash_attention_bwd_dq": flash_mod.KERNEL_BWD_DQ,
    "flash_attention_bwd_wgmma_dq": flash_mod.KERNEL_BWD_WGMMA_DQ,
    "flash_attention_bwd_wgmma_dkdv": flash_mod.KERNEL_BWD_WGMMA_DKDV,
    "flash_attention_bwd_wide_dq": flash_mod.KERNEL_BWD_WIDE_DQ,
    "flash_attention_bwd_wide_dkdv": flash_mod.KERNEL_BWD_WIDE_DKDV,
    "flash_attention_bwd_tf32x3_dq": flash_mod.KERNEL_BWD_TF32X3_DQ,
    "flash_attention_bwd_tf32x3_dkdv": flash_mod.KERNEL_BWD_TF32X3_DKDV,
}


def use_kernel(t: torch.Tensor, backend: str) -> bool:
    """Whether ``backend`` sends tensor ``t`` to the CUDA kernel."""
    if backend == "cuda":
        return True
    if backend == "torch":
        return False
    if backend == "auto":
        return t.device.type == "cuda"
    raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")


def minplus(A: torch.Tensor, B: torch.Tensor, *,
            backend: str = "auto") -> torch.Tensor:
    """Tropical matmul: out[i,j] = min_k A[i,k] + B[k,j]."""
    (M, K), N = A.shape, B.shape[1]
    with charges.charged("minplus", lambda: (
            2.0 * M * N * K, 4 * (M * K + K * N + M * N))):
        if use_kernel(A, backend):
            return minplus_mod.minplus_cuda(A.contiguous(), B.contiguous())
        return ref.minplus_ref(A, B)


def pearson(X: torch.Tensor, *, backend: str = "auto",
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pearson correlation matrix of the rows of X, written into ``out``
    ((n, n) float32) when given: the kernel writes it there directly."""
    n, L = X.shape
    with charges.charged("pearson", lambda: (2.0 * n * n * L,
                                             4 * (n * L + n * n))):
        if use_kernel(X, backend):
            return pearson_mod.pearson_cuda(X.float().contiguous(), out=out)
        S = ref.pearson_ref(X)
        return S if out is None else out.copy_(S)


def masked_argmax(S: torch.Tensor, mask: torch.Tensor, *,
                  backend: str = "auto"):
    """Per-row (max, argmax) of S with True-masked columns excluded."""
    with charges.charged("masked_argmax", lambda: (
            float(S.numel()), charges.nbytes(S, mask) + 8 * S.shape[0])):
        if use_kernel(S, backend):
            return gainscan.masked_argmax_cuda(S, mask)
        return ref.masked_argmax_ref(S, mask)


def topk(X: torch.Tensor, k: int, *, backend: str = "auto",
         row_range: Optional[Tuple[int, int]] = None):
    """Top-k Pearson partners of each row of X, the diagonal excluded:
    (values (n, k) f32, indices (n, k) int32), value desc, index asc.
    ``row_range=(row0, count)``: only those rows of the table, bitwise."""
    def work():
        n, L = X.shape
        r = n if row_range is None else row_range[1]
        return 2.0 * r * n * L, 4 * n * L + 8 * r * k

    with charges.charged("topk", work):
        if use_kernel(X, backend):
            return topk_mod.topk_pearson_cuda(X.float().contiguous(), k,
                                              row_range=row_range)
        return ref.topk_pearson_ref(X, k, row_range=row_range)


def sparse_relax(D: torch.Tensor, graph, *, backend: str = "auto"):
    """One relaxation round over the CSR ``graph`` (a
    ``sparse_apsp.CSRGraph``) on D (s, n): (min(D, candidates), changed),
    where ``changed`` is a one-element device tensor, nonzero iff some
    entry decreased.  The kernel runs on the sources-minor layout; D is
    transposed to it and back."""
    with _relax_charge(D.shape[0], graph, D):
        if use_kernel(D, backend):
            return sparse_mod.sparse_relax_cuda(
                D.contiguous(), graph.indptr, graph.cols, graph.vals)
        out = ref.sparse_relax_ref(D, graph.indptr, graph.cols, graph.vals)
        return out, (out < D).any().view(1)


def _relax_charge(s: int, graph, D: torch.Tensor):
    """One relaxation round of s sources over ``graph``: D read and
    written, the CSR read."""
    return charges.charged("sparse_relax", lambda: (
        2.0 * s * graph.cols.numel(),
        2 * charges.nbytes(D) + charges.nbytes(graph.indptr, graph.cols,
                                               graph.vals)))


def sparse_relax_t(Dt: torch.Tensor, s: int, graph, *, plan=None,
                   out: Optional[torch.Tensor] = None,
                   backend: str = "auto"):
    """One relaxation round on the sources-minor layout Dt (n, sp) of s
    sources (``sparse_apsp.to_sources_minor``): (out (n, sp), changed).
    The kernel takes the graph's work items ``plan``
    (``sparse_apsp.relax_plan``, built here when None), writes into
    ``out`` when given and never writes the padding; the plain version
    relaxes Dt's transpose, padding rows and all, into a new tensor."""
    with _relax_charge(s, graph, Dt):
        if use_kernel(Dt, backend):
            if plan is None:
                plan = sparse_mod.relax_plan(graph.indptr)
            return sparse_mod.sparse_relax_t_cuda(
                Dt.contiguous(), s, graph.indptr, graph.cols, graph.vals,
                plan, out=out)
        out = ref.sparse_relax_ref(Dt.T, graph.indptr, graph.cols,
                                   graph.vals)
        out = out.T.contiguous()
        return out, (out < Dt).any().view(1)


class FlashAttentionFn(torch.autograd.Function):
    """Attention as one differentiable function of q, k, v, on a route:
    a pair of functions ``fwd(q, k, v, **attn) -> (o, lse)`` and
    ``bwd(q, k, v, o, do, lse, **attn) -> (dq, dk, dv)``, contiguous as
    the kernels write them.  ``KERNEL_ROUTE`` (the default) is the flash
    kernels: the forward ``flash_attention_cuda`` (by dtype) with the lse
    it writes beside the output, the backward the hand-written
    ``flash_attention_bwd_cuda`` (by dtype and head dim,
    ``flash_attention.bwd_route``: "wgmma" and "wgmma_wide" for bf16,
    "tf32x3" for fp32).  ``PLAIN_ROUTE``, taken under a cost walk, is
    the plain versions (no lse), outputs of their shapes only on tensors
    without data.  q, k, v, the output and the lse are saved; each call
    is charged as its kernel's.  A failed launch raises."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, route=None):
        fwd, bwd = route or KERNEL_ROUTE
        kw = dict(causal=causal, window=window, scale=scale)
        with _flash_charge(q, k, v, causal, window, saves_lse=True):
            o, lse = fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.attn, ctx.bwd = kw, bwd
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        with _flash_bwd_charge(q, k, v, ctx.attn):
            dq, dk, dv = ctx.bwd(q, k, v, o, do.contiguous(), lse,
                                 **ctx.attn)
        return dq, dk, dv, None, None, None, None


def _kernel_fwd(q, k, v, **attn):
    return flash_mod.flash_attention_cuda(q, k, v, return_lse=True, **attn)


def _kernel_bwd(q, k, v, o, do, lse, **attn):
    return flash_mod.flash_attention_bwd_cuda(q, k, v, o, do, lse=lse,
                                              **attn)


def _plain_fwd(q, k, v, **attn):
    if charges.shapes_only(q):
        return _like(q), None
    return ref.flash_attention_ref(q, k, v, **attn).contiguous(), None


def _plain_bwd(q, k, v, o, do, lse, **attn):
    if charges.shapes_only(q):
        return _like(q), _like(k), _like(v)
    return tuple(g.contiguous() for g in
                 ref.flash_attention_bwd_ref(q, k, v, o, do, **attn))


KERNEL_ROUTE = (_kernel_fwd, _kernel_bwd)
PLAIN_ROUTE = (_plain_fwd, _plain_bwd)


def _like(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor of ``t``'s shape, dtype and device: a kernel's
    output where only its shape is asked for."""
    return torch.empty(t.shape, dtype=t.dtype, device=t.device)


def _flash_charge(q, k, v, causal, window, *, saves_lse: bool):
    """A flash forward: q, k, v read, o written (and the lse where the
    backward needs it)."""
    def work():
        B, Tq, H, _ = q.shape
        lse = 4 * B * H * flash_mod.lse_rows(Tq) if saves_lse else 0
        return (charges.flash(q, k, causal, window, False),
                2 * charges.nbytes(q) + charges.nbytes(k, v) + lse)

    return charges.charged("flash_attention", work)


def _flash_bwd_charge(q, k, v, attn):
    """A flash backward: q, k, v, o, dO and the lse read, dQ, dK, dV
    written."""
    def work():
        B, Tq, H, _ = q.shape
        return (charges.flash(q, k, attn["causal"], attn["window"], True),
                5 * charges.nbytes(q) + 2 * charges.nbytes(k, v)
                + 4 * B * H * flash_mod.lse_rows(Tq))

    return charges.charged("flash_attention_bwd", work)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    backend: str = "auto") -> torch.Tensor:
    """Attention of q (B, Tq, H, hd) over k, v (B, Tk, KV, hd), KV head
    h // (H // KV) for query head h, causal and/or within a sliding
    window (0 = none), the fp32 scores times ``scale`` (None:
    1 / sqrt(hd)); (B, Tq, H, hd) in q's dtype.  On the card bfloat16
    goes to the wgmma kernel and float32 to the CUDA-core one; where
    autograd records and q, k or v needs a gradient, through
    :class:`FlashAttentionFn`, whose backward is a backward kernel (for
    bfloat16 a wgmma one, for float32 the split-TF32 one).
    The plain version is differentiated by autograd itself, but under a
    cost walk, where it goes through :class:`FlashAttentionFn` too."""
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    kernel = use_kernel(q, backend)
    if grad and (kernel or charges.METER is not None):
        return FlashAttentionFn.apply(q, k, v, causal, window, scale,
                                      KERNEL_ROUTE if kernel else PLAIN_ROUTE)
    with _flash_charge(q, k, v, causal, window, saves_lse=False):
        if kernel:
            return flash_mod.flash_attention_cuda(q, k, v, causal=causal,
                                                  window=window, scale=scale)
        if charges.shapes_only(q):
            return _like(q)
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window, scale=scale)


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last reset."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
