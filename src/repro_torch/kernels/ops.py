"""Backend dispatch for the port's kernels.

Backends (``PipelineConfig.backend``):
  * ``"cuda"``  — the hand-written CUDA kernel; raises for a CPU tensor.
  * ``"torch"`` — the plain PyTorch version (``ref.py``) on the tensor's
    own device.
  * ``"auto"``  — the kernel for a tensor on the card, the plain version
    for a tensor on the CPU (mirroring ``repro.kernels.ops._resolve``,
    which picks Pallas on a TPU and jnp elsewhere).

A failed build or launch raises; nothing falls back to the plain
version.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import gainscan, minplus as minplus_mod, pearson as pearson_mod, ref
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
    if use_kernel(A, backend):
        return minplus_mod.minplus_cuda(A.contiguous(), B.contiguous())
    return ref.minplus_ref(A, B)


def pearson(X: torch.Tensor, *, backend: str = "auto",
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pearson correlation matrix of the rows of X, written into ``out``
    ((n, n) float32) when given: the kernel writes it there directly."""
    if use_kernel(X, backend):
        return pearson_mod.pearson_cuda(X.float().contiguous(), out=out)
    S = ref.pearson_ref(X)
    return S if out is None else out.copy_(S)


def masked_argmax(S: torch.Tensor, mask: torch.Tensor, *,
                  backend: str = "auto"):
    """Per-row (max, argmax) of S with True-masked columns excluded."""
    if use_kernel(S, backend):
        return gainscan.masked_argmax_cuda(S, mask)
    return ref.masked_argmax_ref(S, mask)


def topk(X: torch.Tensor, k: int, *, backend: str = "auto"):
    """Top-k Pearson partners of each row of X, the diagonal excluded:
    (values (n, k) f32, indices (n, k) int32), value desc, index asc."""
    if use_kernel(X, backend):
        return topk_mod.topk_pearson_cuda(X.float().contiguous(), k)
    return ref.topk_pearson_ref(X, k)


def sparse_relax(D: torch.Tensor, graph, *, backend: str = "auto"):
    """One relaxation round over the CSR ``graph`` (a
    ``sparse_apsp.CSRGraph``) on D (s, n): (min(D, candidates), changed),
    where ``changed`` is a one-element device tensor, nonzero iff some
    entry decreased.  The kernel runs on the sources-minor layout; D is
    transposed to it and back."""
    if use_kernel(D, backend):
        return sparse_mod.sparse_relax_cuda(
            D.contiguous(), graph.indptr, graph.cols, graph.vals)
    out = ref.sparse_relax_ref(D, graph.indptr, graph.cols, graph.vals)
    return out, (out < D).any().view(1)


def sparse_relax_t(Dt: torch.Tensor, s: int, graph, *, plan=None,
                   out: Optional[torch.Tensor] = None,
                   backend: str = "auto"):
    """One relaxation round on the sources-minor layout Dt (n, sp) of s
    sources (``sparse_apsp.to_sources_minor``): (out (n, sp), changed).
    The kernel takes the graph's work items ``plan``
    (``sparse_apsp.relax_plan``, built here when None), writes into
    ``out`` when given and never writes the padding; the plain version
    relaxes Dt's transpose, padding rows and all, into a new tensor."""
    if use_kernel(Dt, backend):
        if plan is None:
            plan = sparse_mod.relax_plan(graph.indptr)
        return sparse_mod.sparse_relax_t_cuda(
            Dt.contiguous(), s, graph.indptr, graph.cols, graph.vals, plan,
            out=out)
    out = ref.sparse_relax_ref(Dt.T, graph.indptr, graph.cols, graph.vals)
    out = out.T.contiguous()
    return out, (out < Dt).any().view(1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    backend: str = "auto") -> torch.Tensor:
    """Attention of q (B, Tq, H, hd) over k, v (B, Tk, KV, hd), KV head
    h // (H // KV) for query head h, causal and/or within a sliding
    window (0 = none), the fp32 scores times ``scale`` (None:
    1 / sqrt(hd)); (B, Tq, H, hd) in q's dtype.  On the card bfloat16
    goes to the wgmma kernel and float32 to the CUDA-core one."""
    if use_kernel(q, backend):
        return flash_mod.flash_attention_cuda(q, k, v, causal=causal,
                                              window=window, scale=scale)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last reset."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
