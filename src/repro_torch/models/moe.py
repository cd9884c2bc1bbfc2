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

On a batch whose rows are split over data ranks (the mesh train step
binds ``moe_data``, a ``dist.hints.DataRanks``), the groups, their
capacity and the aux loss are the reference's on the global batch.
Where each rank holds whole groups, it dispatches them as above.  Where
a group spans ranks, each rank routes its own tokens, and one sum over
the ranks of every (group, rank)'s per-expert counts and router
probability sums gives each rank its offset into every expert (an
exclusive prefix over the ranks before it), the group's counts and the
other ranks' share of the mean probability.  A rank's aux loss is its
share of its groups' values, with the gradient through its own tokens'
probabilities scaled so that the mean over the data ranks of the ranks'
gradients is the reference's.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..dist import hints
from ..dist import tensor_parallel as tp_mod
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


def tp_blocks(cfg) -> dict:
    """The MoE leaves' compute blocks over the model ranks: the router
    whole; each expert's (and the shared experts') d_ff split, the up
    projections on their columns and the down one on its rows."""
    ff = cfg.d_ff
    b = {"router": tp_mod.WHOLE, "wg": tp_mod.split(2, ff),
         "wu": tp_mod.split(2, ff), "wd": tp_mod.split(1, ff)}
    if cfg.n_shared_experts:
        sff = cfg.n_shared_experts * ff
        b["shared"] = {"wg": tp_mod.split(1, sff), "wu": tp_mod.split(1, sff),
                       "wd": tp_mod.split(0, sff)}
    return b


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
    xf = tp_mod.enter(xf)
    return tp_mod.leave((F.silu(xf @ sp["wg"]) * (xf @ sp["wu"])) @ sp["wd"])


def moe_apply(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (out (B, T, d), aux load-balance loss, a 0-d fp32
    tensor: the mean over the dispatch groups).  Under a ``moe_data``
    binding of more than one rank, x is this rank's rows of the global
    batch and the groups are the global batch's (the module's
    docstring)."""
    B, T, d = x.shape
    N = B * T
    ranks = hints.get("moe_data")
    xf = x.reshape(N, d)
    if ranks is not None and ranks.size > 1:
        n_g = ranks.size * N // _n_groups(ranks.size * N)
        if N % n_g:
            out, aux = _spanning_groups(p, xf, cfg, ranks, n_g)
            if cfg.n_shared_experts:
                out = out + _shared(p, xf)
            return out.reshape(B, T, d), aux
        G = N // n_g
    else:
        G = _n_groups(N)
    outs, auxs = zip(*(_moe_dispatch_one(p, xg, cfg)
                       for xg in xf.reshape(G, N // G, d)))
    out = torch.cat(outs) if G > 1 else outs[0]
    if cfg.n_shared_experts:
        out = out + _shared(p, xf)
    return out.reshape(B, T, d), torch.stack(auxs).mean()


def _spanning_groups(p, xf: torch.Tensor, cfg, ranks, n_g: int):
    """The MoE on this rank's tokens xf (N, d) where some dispatch group
    of n_g tokens spans ranks: (out (N, d), this rank's aux)."""
    N, d = xf.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    R, q = ranks.size, ranks.index
    G = R * N // n_g
    C = _capacity(cfg, n_g)
    # the slices [a, b) of this rank's tokens in group g, in order
    pieces, t = [], q * N
    while t < (q + 1) * N:
        g = t // n_g
        end = min((g + 1) * n_g, (q + 1) * N)
        pieces.append((g, t - q * N, end - q * N))
        t = end
    routed = [route(p, xf[a:b], cfg) for _, a, b in pieces]
    # per (group, rank): each expert's pairs and summed probabilities
    stats = torch.zeros((G, R, 2, E), dtype=torch.float32, device=xf.device)
    for (g, _, _), (probs, _, topi) in zip(pieces, routed):
        stats[g, q, 0] = _expert_counts(topi.reshape(-1), E).float()
        stats[g, q, 1] = probs.detach().sum(0)
    ranks.all_reduce(stats)
    outs, aux = [], 0.0
    for (g, a, b), (probs, topv, topi) in zip(pieces, routed):
        counts, psum = stats[g, :, 0], stats[g, :, 1]
        others = torch.cat([psum[:q], psum[q + 1:]]).sum(0)
        me = (probs.sum(0) + others) / n_g
        # each expert's 1 / (n_g k) added once a pair, as the reference
        # adds them (its rounding depends on the count alone)
        pe = torch.repeat_interleave(
            torch.arange(E, device=xf.device), counts.sum(0).long(),
            output_size=n_g * k)
        ce = torch.zeros((E,), dtype=torch.float32, device=xf.device) \
            .index_add_(0, pe, torch.full((n_g * k,), 1.0 / (n_g * k),
                                          device=xf.device))
        aux_g = E * torch.sum(me * ce)
        # value: this rank's share of the group; gradient: its tokens'
        aux = aux + (R / G) * ((b - a) / n_g * aux_g.detach()
                               + (aux_g - aux_g.detach()))
        before = counts[:q].sum(0).long()
        outs.append(_experts(p, xf[a:b], topv, topi, C, E, before))
    return torch.cat(outs) if len(outs) > 1 else outs[0], aux


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


def _expert_counts(pe: torch.Tensor, E: int) -> torch.Tensor:
    """(E,) int64: how many of the pairs' experts pe are each expert (a
    bincount whose shape does not depend on the values)."""
    return torch.zeros((E,), dtype=torch.long, device=pe.device) \
        .index_add_(0, pe, torch.ones_like(pe))


def dispatch(topi: torch.Tensor, C: int, E: int,
             before: Optional[torch.Tensor] = None):
    """The sort-based dispatch of top-k experts topi (N, k): (order, the
    pairs' token ids in expert order, keep, slot), where ``slot`` is
    ``expert * C + rank`` for a kept pair and the sink ``E * C`` for a
    dropped one.  ``order`` is the stable argsort of the flattened pairs
    by expert.  ``before`` (E,): each expert's pairs in the group ahead of
    these tokens (held by earlier ranks), added to the ranks."""
    N, k = topi.shape
    dev = topi.device
    pe = topi.reshape(-1)
    ptok = torch.arange(N, device=dev).repeat_interleave(k)
    order = torch.sort(pe, stable=True).indices
    pe_s, ptok_s = pe[order], ptok[order]
    counts = _expert_counts(pe_s, E)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(N * k, device=dev) - starts[pe_s]
    if before is not None:
        rank = rank + before[pe_s]
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
    return _experts(p, xf, topv, topi, C, E), aux


def _experts(p, xf: torch.Tensor, topv: torch.Tensor, topi: torch.Tensor,
             C: int, E: int, before: Optional[torch.Tensor] = None):
    """The dispatch of the routed tokens xf (N, d) into the (E, C, d)
    buffer, the experts and the combine: (N, d)."""
    N, d = xf.shape
    order, ptok_s, keep, slot = dispatch(topi, C, E, before)
    pw_s = topv.reshape(-1).to(xf.dtype)[order]
    buf = torch.zeros((E * C + 1, d), dtype=xf.dtype, device=xf.device)
    buf[slot] = xf[ptok_s]
    buf = hints.constrain(buf[:-1].reshape(E, C, d), "moe_expert")

    buf = tp_mod.enter(buf)
    h = F.silu(torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wu"])
    y = tp_mod.leave(torch.bmm(h, p["wd"]))                     # (E, C, d)
    y = hints.constrain(y, "moe_expert")
    return combine(y, keep, slot, pw_s, ptok_s, N)


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
