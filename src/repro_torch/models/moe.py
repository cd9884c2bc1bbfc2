"""Mixture-of-experts FFN with sort-based capacity dispatch.

The port of ``repro.models.moe``.  Dispatch is the "sort by expert"
formulation: each (token, expert) pair of the router's top-k is sorted
by expert (a stable sort), ranked within its expert, and written to slot
``expert * C + rank`` of an (E, C, d) buffer when ``rank < C``; pairs
past an expert's capacity C go to the sink slot ``E * C`` and are
dropped (the residual passes through).  The experts run as batched
products over the buffer, and the combine adds each kept pair's output,
times its gate weight, to its token, in the reference's order and
without atomics (the same sum in every run on the card).

The router runs in fp32.  ``lax.top_k`` breaks ties by lowest index and
``torch.topk`` promises no tie order, so the top-k is a stable
descending sort.  Tokens are dispatched in groups (``_n_groups``): from
4096 tokens up, groups of at least 2048 tokens, each with its own
capacity, as the reference groups them; shared experts run after the
dispatch, on every token.  The (E, C, d) dispatch buffer and the
experts' output carry the ``moe_expert`` layout hint
(``dist.hints.constrain``), as in the reference.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..dist import hints
from .layers import dense_init


def moe_init(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def experts(d_in, d_out):
        w = torch.randn((E, d_in, d_out), generator=gen, device=gen.device)
        return (w * (1.0 / math.sqrt(d_in))).to(dtype)

    p = {"router": dense_init(gen, d, E, torch.float32),
         "wg": experts(d, ff), "wu": experts(d, ff), "wd": experts(ff, d)}
    if cfg.n_shared_experts:
        sff = cfg.n_shared_experts * ff
        p["shared"] = {"wg": dense_init(gen, d, sff, dtype),
                       "wu": dense_init(gen, d, sff, dtype),
                       "wd": dense_init(gen, sff, d, dtype)}
    return p


def _capacity(cfg, T: int) -> int:
    c = math.ceil(cfg.capacity_factor * T * cfg.moe_top_k / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _n_groups(N: int) -> int:
    """Dispatch groups: the reference's, aligned to its 32-wide data axes,
    only where each group keeps at least 2048 tokens."""
    for g in (32, 16, 8, 4, 2):
        if N % g == 0 and N // g >= 2048:
            return g
    return 1


def _shared(p, xf: torch.Tensor) -> torch.Tensor:
    sp = p["shared"]
    return (F.silu(xf @ sp["wg"]) * (xf @ sp["wu"])) @ sp["wd"]


def moe_apply(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (out (B, T, d), aux load-balance loss, a 0-d fp32
    tensor: the mean over the dispatch groups)."""
    B, T, d = x.shape
    N = B * T
    G = _n_groups(N)
    xf = x.reshape(N, d)
    outs, auxs = zip(*(_moe_dispatch_one(p, xg, cfg)
                       for xg in xf.reshape(G, N // G, d)))
    out = torch.cat(outs) if G > 1 else outs[0]
    if cfg.n_shared_experts:
        out = out + _shared(p, xf)
    return out.reshape(B, T, d), torch.stack(auxs).mean()


def route(p, xf: torch.Tensor, cfg):
    """The fp32 router of one group xf (N, d): (probs (N, E), top-k
    weights renormalised (N, k), top-k experts (N, k) int64), ties to the
    lowest expert."""
    logits = xf.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe_top_k
    topv, topi = topv[:, :k], topi[:, :k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return probs, topv, topi


def dispatch(topi: torch.Tensor, C: int, E: int):
    """The sort-based dispatch of top-k experts topi (N, k): (order, the
    pairs' token ids in expert order, keep, slot), where ``slot`` is
    ``expert * C + rank`` for a kept pair and the sink ``E * C`` for a
    dropped one.  ``order`` is the stable argsort of the flattened pairs
    by expert."""
    N, k = topi.shape
    dev = topi.device
    pe = topi.reshape(-1)
    ptok = torch.arange(N, device=dev).repeat_interleave(k)
    order = torch.sort(pe, stable=True).indices
    pe_s, ptok_s = pe[order], ptok[order]
    counts = torch.bincount(pe_s, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(N * k, device=dev) - starts[pe_s]
    keep = rank < C
    slot = torch.where(keep, pe_s * C + rank, E * C)
    return order, ptok_s, keep, slot


def combine(y: torch.Tensor, keep: torch.Tensor, slot: torch.Tensor,
            pw_s: torch.Tensor, ptok_s: torch.Tensor, N: int) -> torch.Tensor:
    """Each kept pair's expert output y (E, C, d), times its gate weight
    pw_s (in y's dtype), summed into its token: (N, d).

    The reference scatter-adds the pairs in their sorted order, so each
    token's k pairs arrive in expert order; here they are grouped by
    token (a stable sort keeps that order) and added one after another
    from zero, the same association, without atomics: on the card the
    sum is the same in every run."""
    E, C, d = y.shape
    yf = y.reshape(E * C, d)
    gathered = torch.where(keep[:, None], yf[torch.where(keep, slot, 0)], 0)
    gathered = gathered * pw_s[:, None]
    by_token = torch.sort(ptok_s, stable=True).indices
    g = gathered[by_token].reshape(N, -1, d)
    out = torch.zeros((N, d), dtype=y.dtype, device=y.device)
    for j in range(g.shape[1]):
        out = out + g[:, j]
    return out


def _moe_dispatch_one(p, xf: torch.Tensor, cfg):
    """Sort-based dispatch for one token group xf (N, d): (out (N, d),
    aux)."""
    N, d = xf.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    C = _capacity(cfg, N)
    probs, topv, topi = route(p, xf, cfg)

    # Switch-style aux loss: E * sum_e f_e * P_e
    me = probs.mean(dim=0)
    ce = torch.zeros((E,), dtype=torch.float32, device=xf.device) \
        .index_add_(0, topi.reshape(-1),
                    torch.full((N * k,), 1.0 / (N * k), device=xf.device))
    aux = E * torch.sum(me * ce)

    order, ptok_s, keep, slot = dispatch(topi, C, E)
    pw_s = topv.reshape(-1).to(xf.dtype)[order]
    buf = torch.zeros((E * C + 1, d), dtype=xf.dtype, device=xf.device)
    buf[slot] = xf[ptok_s]
    buf = hints.constrain(buf[:-1].reshape(E, C, d), "moe_expert")

    h = F.silu(torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wu"])
    y = torch.bmm(h, p["wd"])                                   # (E, C, d)
    y = hints.constrain(y, "moe_expert")
    return combine(y, keep, slot, pw_s, ptok_s, N), aux


def moe_apply_dense_ref(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """O(T E) dense oracle: every expert on every token, masked combine
    (no capacity drops); the plain twin of the sort-based dispatch."""
    B, T, d = x.shape
    xf = x.reshape(-1, d)
    probs, topv, topi = route(p, xf, cfg)
    gates = torch.zeros_like(probs).scatter_(1, topi, topv)     # (N, E)
    h = F.silu(torch.einsum("nd,edf->nef", xf, p["wg"]))
    h = h * torch.einsum("nd,edf->nef", xf, p["wu"])
    y = torch.einsum("nef,efd->ned", h, p["wd"])
    out = torch.einsum("ne,ned->nd", gates.to(x.dtype), y)
    if cfg.n_shared_experts:
        out = out + _shared(p, xf)
    return out.reshape(B, T, d)
