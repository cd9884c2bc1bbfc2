"""Plain PyTorch versions of the port's CUDA kernels.

Each function is the twin of the same-named oracle in
``repro.kernels.ref`` and computes exactly what the hand-written kernel
computes.  The wrappers in ``kernels/ops.py`` run these for tensors on
the CPU (that is how the CPU tests run the whole port), the tests hold
them against the JAX package, and ``chip_smoke.py`` holds every kernel
against its twin on the card.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG = float("-inf")

# Elements of the (m, panel, n) broadcast that one min-plus k-panel may
# hold: 2**26 float32 = 256 MiB, so the plain product fits beside the
# (n, n) matrices at the main path's widths.
_MINPLUS_PANEL_ELEMS = 1 << 26


def minplus_ref(A: torch.Tensor, B: torch.Tensor, *,
                panel: int = 0) -> torch.Tensor:
    """Tropical (min-plus) matrix product: out[i,j] = min_k A[i,k] + B[k,j].

    Blocked over k like ``repro.kernels.minplus.minplus_jnp``: each
    k-panel's (m, panel, n) broadcast is reduced into a running minimum,
    so the peak memory is bounded whatever k is.  ``panel=0`` picks the
    widest panel under a fixed element budget.  The result does not
    depend on the panel: every entry is the minimum of the same exactly
    rounded sums.
    """
    m, k = A.shape
    k2, n = B.shape
    if k != k2:
        raise ValueError(f"inner sizes differ: {tuple(A.shape)} x "
                         f"{tuple(B.shape)}")
    A = A.float()
    B = B.float()
    if panel <= 0:
        panel = max(1, _MINPLUS_PANEL_ELEMS // max(m * n, 1))
    panel = min(panel, k)
    out = torch.full((m, n), float("inf"), dtype=torch.float32,
                     device=A.device)
    for k0 in range(0, k, panel):
        a = A[:, k0:k0 + panel]
        b = B[k0:k0 + panel, :]
        torch.minimum(out, (a[:, :, None] + b[None, :, :]).amin(dim=1),
                      out=out)
    return out


def standardize_rows(X: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Center and L2-normalize rows so Z @ Z.T is Pearson correlation."""
    X = X.float()
    mu = X.mean(dim=1, keepdim=True)
    Z = X - mu
    denom = torch.sqrt(torch.sum(Z * Z, dim=1, keepdim=True)) + eps
    return Z / denom


def pearson_ref(X: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Pearson correlation matrix of the rows of X (n, L) -> (n, n).

    The product runs in full fp32: the package turns TF32 off on import
    (``repro_torch/__init__.py``)."""
    Z = standardize_rows(X, eps)
    return torch.clamp(Z @ Z.T, -1.0, 1.0)


def masked_argmax_ref(S: torch.Tensor, mask: torch.Tensor):
    """Per-row (max value, argmax index) of S with masked columns excluded.

    ``mask`` is (n,) bool; True columns are excluded (read as -inf).
    Ties break to the lowest index; a fully masked row gives (-inf, 0).
    Returns (values (m,) f32, indices (m,) int32).
    """
    masked = S.float().masked_fill(mask[None, :], NEG)
    vals, idx = masked.max(dim=1)
    return vals, idx.int()


def topk_pearson_ref(X: torch.Tensor, k: int, *, bm: int = 128,
                     row_range: Optional[Tuple[int, int]] = None):
    """Top-k Pearson partners of each row of X (n, L), the diagonal
    excluded: (values (n, k) f32, indices (n, k) int32), ordered by value
    descending, then index ascending.

    The twin of ``repro.kernels.topk.topk_pearson_jnp``: it walks (bm, n)
    row panels, ``clip(Z[panel] @ Z.T)`` with the diagonal set to -inf,
    and keeps the first k of a stable descending sort, so the (n, n)
    matrix never exists.

    ``row_range=(row0, count)`` returns only rows row0 .. row0 + count - 1
    of that table: the panels that hold them are the whole table's
    panels (the same products on the same operands), so the range is
    bitwise those rows of it.
    """
    n = X.shape[0]
    if not 1 <= k <= n - 1:
        raise ValueError(f"need 1 <= k <= n-1, got k={k} for n={n}")
    row0, count = (0, n) if row_range is None else row_range
    if row0 < 0 or count < 1 or row0 + count > n:
        raise ValueError(f"row range ({row0}, {count}) outside 0..{n}")
    Z = standardize_rows(X)
    vals, idxs = [], []
    for r0 in range(row0 // bm * bm, row0 + count, bm):
        s = torch.clamp(Z[r0:r0 + bm] @ Z.T, -1.0, 1.0)
        rows = torch.arange(s.shape[0], device=s.device)
        s[rows, rows + r0] = NEG
        v, i = torch.sort(s, dim=1, descending=True, stable=True)
        a, b = max(row0 - r0, 0), min(row0 + count - r0, s.shape[0])
        vals.append(v[a:b, :k].contiguous())
        idxs.append(i[a:b, :k].int())
    return torch.cat(vals), torch.cat(idxs)


def gather_add_ref(D: torch.Tensor, cols: torch.Tensor,
                   vals: torch.Tensor) -> torch.Tensor:
    """cand[s, e] = D[s, cols[e]] + vals[e]: the twin of the Pallas tile
    ``repro.kernels.sparse_apsp.gather_add_pallas``."""
    return D[:, cols.long()] + vals[None, :]


def sparse_relax_ref(D: torch.Tensor, indptr: torch.Tensor,
                     cols: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """One multi-source relaxation round over a row-sorted CSR graph:

        out[s, v] = min(D[s, v], min_{e in row v} D[s, cols[e]] + vals[e])

    The twin of the ``"jnp"`` branch of
    ``repro.kernels.sparse_apsp.sparse_relax``: a gather, an add, a
    segmented minimum over the rows, and ``minimum(D, .)``.  Every step
    propagates NaN; an empty row keeps D."""
    s, n = D.shape
    cand = gather_add_ref(D, cols, vals)                 # (s, m)
    lengths = (indptr[1:] - indptr[:-1]).long().expand(s, n)
    upd = torch.segment_reduce(cand, "min", lengths=lengths, axis=1,
                               initial=float("inf"))
    return torch.minimum(D, upd)


# masked attention scores: finite, so exp(NEG - NEG) = 1, never NaN
ATTN_NEG = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Dense attention of q (B, Tq, H, hd) over k, v (B, Tk, KV, hd) with
    the KV head of query head h at h // (H // KV): an fp32 softmax over
    the keys with (causal) s <= t and (window > 0) t - s < window, the
    rest masked with the finite ``ATTN_NEG``.  q is cast to fp32 and
    then divided by sqrt(hd) (``scale=None``, the Pallas semantics) or
    multiplied by ``scale``.  Returns (B, Tq, H, hd) in q's dtype.

    The twin of ``repro.kernels.flash_attention.flash_attention_ref``,
    the oracle of ``flash_attention_pallas``; the (B, KV, G, Tq, Tk)
    scores exist whole."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qh = q.reshape(B, Tq, KV, G, hd).float()
    qh = qh / math.sqrt(hd) if scale is None else qh * scale
    s = torch.einsum("bqKgh,bsKh->bKgqs", qh, k.float())
    qi = torch.arange(Tq, device=q.device)[:, None]
    ki = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window > 0:
        mask &= (qi - ki) < window
    s = torch.where(mask, s, ATTN_NEG)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bKgqs,bsKh->bKgqh", w, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, hd).to(q.dtype)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, *, causal: bool = True,
                            window: int = 0, scale: Optional[float] = None):
    """The plain fp32 backward of :func:`flash_attention_ref`: (dq, dk,
    dv) in the inputs' dtypes, given the forward's output ``o`` (B, Tq,
    H, hd) and its gradient ``do``.  It recomputes the scores s and the
    probabilities p, then D = rowsum(dO o), dV = p^T dO, dS = p (dO v^T
    - D), dQ = scale dS k and dK = scale dS^T q, dK and dV summed over
    the G query heads of each KV head.  The backward kernel's oracle
    (``flash_attention.flash_attention_bwd_cuda``)."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    mul = 1.0 / math.sqrt(hd) if scale is None else scale
    qh = q.reshape(B, Tq, KV, G, hd).float()
    qh = qh / math.sqrt(hd) if scale is None else qh * scale
    s = torch.einsum("bqKgh,bsKh->bKgqs", qh, k.float())
    qi = torch.arange(Tq, device=q.device)[:, None]
    ki = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window > 0:
        mask &= (qi - ki) < window
    p = torch.softmax(torch.where(mask, s, ATTN_NEG), dim=-1)
    doh = do.reshape(B, Tq, KV, G, hd).float()
    D = torch.einsum("bqKgh,bqKgh->bKgq", doh,
                     o.reshape(B, Tq, KV, G, hd).float())
    dv = torch.einsum("bKgqs,bqKgh->bsKh", p, doh)
    dp = torch.einsum("bqKgh,bsKh->bKgqs", doh, v.float())
    ds = p * (dp - D[..., None])
    dq = torch.einsum("bKgqs,bsKh->bqKgh", ds, k.float()) * mul
    dk = torch.einsum("bKgqs,bqKgh->bsKh", ds, qh)
    return (dq.reshape(B, Tq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
