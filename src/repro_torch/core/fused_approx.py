"""The approx and sparse pipeline's default (fused) body: no (n, n)
buffer on the sparse tail.

The port of ``repro.core.fused_approx`` (DESIGN.md §17): the body
``cluster()`` runs by default for ``similarity="topk"`` and for
``apsp_method="sparse"``.  The reference traces it into one program over
static shapes; the port runs the same stages eagerly, in the same order,
with the same arithmetic.  :func:`fused_one` has the reference's bodies:

  * dense S (given, or ``ops.pearson``) → TMFG by ``cfg.method``
    (``tmfg._build``) → the sparse tail on the TMFG's S entries;
  * the top-K table (``ops.topk``, the CUDA kernel on the card, or cut
    from a given S) → the lazy sparse TMFG on the table
    (``approx/sparse_tmfg.py``) → the tail :func:`use_sparse_tail`
    picks: the sparse tail, or the dense tail the staged path runs;
  * the table densified (``knn.densify``) → TMFG by the non-lazy
    ``cfg.method`` → the tail :func:`use_sparse_tail` picks.

The sparse tail (:func:`_sparse_tail`): the CSR of the TMFG's edge
lengths and the hub factor D_h (h, n) (``apsp.hub_factor_sparse``:
``ops.sparse_relax``, the CUDA kernel), the bubble-tree directions from
the edge list (prefix sums, below), the converging flow, then the stages
it shares with the staged tail (``core/sparse_dbht.py``): the (512, n)
panel sweep of the composed distances (``ops.minplus``) and the nested
HAC, one complete linkage per coarse cluster block
(``ops.masked_argmax``), one over the clusters, and the assembly.

Where the port departs from the reference's shapes, and why the result
does not change:

  * the reference's slot grid (power-of-two member tiers for
    ``lax.switch``) becomes one block per cluster sized to its members:
    the real merges of a tier-padded block are those of the unpadded one;
  * the Euler tour of the bubble tree runs on the host in numpy (two
    O(B) loops of scalar steps would be ~2B launches on the card), and
    the linkage is assembled on the host (an O(n) bookkeeping pass);
  * the direction stage takes its prefix sums in float64 where the
    reference takes them in float32: at the Crop size the running sum
    reaches ~1e5, where one float32 ulp is ~0.008, so the side-strength
    comparison of the float32 form can flip on many tree edges.  The
    float64 sums agree with the reference's float64 oracle
    (``sparse_dbht._directions_sparse``) except at true near-ties
    (ROADMAP Queue 3).

``overflow`` is reported as the reference reports it (more coarse
clusters than ``c_cap`` or a cluster larger than ``m_cap``), and
``cluster()`` then reruns the staged path with the same config, as the
reference does.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.approx import knn as knn_mod
from repro_torch.approx import sparse_tmfg as sparse_tmfg_mod
from repro_torch.kernels import ops
from repro_torch.kernels.ref import standardize_rows
from repro_torch.kernels.sparse_apsp import csr_from_edges

from . import apsp as apsp_mod
from . import dbht as dbht_mod
from .dbht import euler_tour
from .sparse_dbht import _sweep_panels, edge_lengths_from_sim, nested_linkage
from .tmfg import TMFGResult, _build, adjacency_from_weights

# The reference's slot-grid caps (DESIGN.md §17.3): at most c_cap coarse
# clusters of at most m_cap members, c_cap = max(FUSED_C_CAP, 4 isqrt(n)).
FUSED_C_CAP = 64
FUSED_M_CAP = 2048

# the reference's int32 composite sort keys bound the fused path to
# n^2 < 2^31; the port keeps the bound so both packages take one input set
FUSED_MAX_N = 46_340


def _next_pow2(x: int) -> int:
    return 1 << max(1, (x - 1).bit_length())


def fused_caps(n: int) -> Tuple[int, int]:
    """(c_cap, m_cap) for problem size n, as the reference computes them:
    max(FUSED_C_CAP, 4 isqrt(n)) and FUSED_M_CAP, clamped to what n can
    produce."""
    c_cap = max(FUSED_C_CAP, 4 * math.isqrt(n))
    m_cap = FUSED_M_CAP
    c_cap = max(2, min(c_cap, max(2, n - 3)))
    m_cap = max(2, min(m_cap, _next_pow2(n)))
    return c_cap, m_cap


def use_sparse_tail(cfg, n: int) -> bool:
    """The reference's dispatch: the sparse tail runs when the config asks
    for it (``apsp_method="sparse"``), and for the lazy approx default at
    the sizes where the staged path would run hub APSP (n >= HUB_MIN_N);
    otherwise the dense tail, as the staged path."""
    if cfg.apsp_method == "sparse":
        return True
    return (cfg.similarity == "topk" and cfg.method == "lazy"
            and cfg.apsp_method == "hub" and n >= apsp_mod.HUB_MIN_N)


# ---------------------------------------------------------------------------
# directions from the edge list (DESIGN.md §17.2)
# ---------------------------------------------------------------------------

def _device_directions_sparse(n: int, edges: torch.Tensor,
                              w_sim: torch.Tensor,
                              parent: torch.Tensor, tri: torch.Tensor,
                              home_bubble: torch.Tensor) -> torch.Tensor:
    """±1 bubble-tree edge directions (B,) int32 from the edge list.

    Per tree edge b and triangle corner v, v's adjacency is summed into
    the child side when the neighbour's home bubble lies in b's subtree,
    else the parent side, in-triangle neighbours excluded.  The subtree
    sums are range queries on a float64 prefix sum over the directed
    entries sorted by (source, preorder slot of the neighbour's home);
    the six in-triangle ordered pairs are taken out by key lookups.
    Entry 0 (the root) is 0."""
    dev = edges.device
    B = parent.shape[0]
    tin_h, tout_h = euler_tour(parent.cpu().numpy())
    tin = torch.from_numpy(tin_h).to(dev)
    tout = torch.from_numpy(tout_h).to(dev)
    home_tin = tin[home_bubble.long()]                       # (n,)

    e = edges.long()
    src = torch.cat([e[:, 0], e[:, 1]])
    dst = torch.cat([e[:, 1], e[:, 0]])
    w2 = torch.cat([w_sim, w_sim]).double()

    key = src * n + home_tin[dst]
    order = torch.sort(key, stable=True).indices
    key_s = key[order]
    cum = torch.cat([torch.zeros(1, dtype=torch.float64, device=dev),
                     torch.cumsum(w2[order], 0)])

    skey = src * n + dst                                     # pair lookups
    so = torch.sort(skey, stable=True).indices
    skey_s, sw_s = skey[so], w2[so]

    def pair_w(u, v):
        q = u * n + v
        pos = torch.searchsorted(skey_s, q).clamp_(0, skey_s.shape[0] - 1)
        return torch.where(skey_s[pos] == q, sw_s[pos], 0.0)

    def range_sum(lo, hi):
        p_lo = torch.searchsorted(key_s, lo.reshape(-1)).reshape(B, 3)
        p_hi = torch.searchsorted(key_s, hi.reshape(-1)).reshape(B, 3)
        return cum[p_hi] - cum[p_lo]

    t = tri.long().clamp(min=0)                  # row 0 (the root) is -1s
    in_range = range_sum(t * n + tin[:, None], t * n + tout[:, None])
    s_child = (in_range[:, 0] + in_range[:, 1]) + in_range[:, 2]
    tot = range_sum(t * n, t * n + n)            # every neighbour of v
    s_parent = ((tot[:, 0] + tot[:, 1]) + tot[:, 2]) - s_child

    for i in range(3):                   # drop the 6 in-triangle pairs
        for j in range(3):
            if i == j:
                continue
            w_e = pair_w(t[:, i], t[:, j])
            ht = home_tin[t[:, j]]
            inr = (ht >= tin) & (ht < tout)
            s_child = s_child - torch.where(inr, w_e, 0.0)
            s_parent = s_parent - torch.where(inr, 0.0, w_e)

    direction = torch.where(s_child >= s_parent, 1, -1).to(torch.int32)
    direction[0] = 0
    return direction


# ---------------------------------------------------------------------------
# the sparse tail
# ---------------------------------------------------------------------------

def _sparse_tail(cfg, n: int, tm: TMFGResult,
                 w_sim: torch.Tensor) -> Dict[str, object]:
    """TMFG edge list + per-edge similarities -> sparse DBHT outputs (the
    keys of ``dbht.dense_tail``'s dict plus hubs, overflow and
    bf_rounds).  Where the coarse clusters overflow the reference's slot
    caps it stops there and returns only overflow and bf_rounds."""
    dev = w_sim.device
    graph = csr_from_edges(n, tm.edges, edge_lengths_from_sim(w_sim))
    stats = {}
    hubs, D_h = apsp_mod.hub_factor_sparse(
        graph, n_hubs=cfg.apsp_hubs, rounds=cfg.apsp_rounds,
        backend=cfg.backend, stats=stats)

    direction = _device_directions_sparse(
        n, tm.edges, w_sim, tm.bubble_parent, tm.bubble_tri, tm.home_bubble)
    _, dest, conv_mask = dbht_mod._device_flow(tm.bubble_parent, direction)
    conv_id = torch.cumsum(conv_mask.to(torch.int32), 0,
                           dtype=torch.int32) - 1
    bubble_cluster = conv_id.index_select(0, dest)
    cluster_of = bubble_cluster.index_select(0, tm.home_bubble.long())

    cluster_h = cluster_of.cpu().numpy().astype(np.int64)
    C = int(conv_mask.sum())
    counts = np.bincount(cluster_h, minlength=C)
    c_cap, m_cap = fused_caps(n)
    if C > c_cap or int(counts.max()) > m_cap:
        # the reference's overflow: its slot grid cannot hold these
        # clusters, and the caller reruns the staged path
        return dict(overflow=True, bf_rounds=stats["bf_rounds"])

    bubble_of, dmax, ccm = _sweep_panels(
        D_h, graph, tm.bubble_verts, bubble_cluster, cluster_of, C,
        cfg.backend)
    # clusters are within m_cap <= SPARSE_EXACT_HAC_MAX: no tree mode,
    # which alone reads the TMFG's host arrays
    Z = nested_linkage(D_h, graph, None, cluster_h, None, bubble_of, C,
                       dmax, ccm, backend=cfg.backend)
    return dict(direction=direction, conv_mask=conv_mask,
                cluster_of=cluster_of, bubble_of=bubble_of, D=D_h, Z=Z,
                hubs=hubs.int(), overflow=False, bf_rounds=stats["bf_rounds"])


def _check_n(n: int) -> None:
    if n > FUSED_MAX_N:
        raise ValueError(
            f"fused approx path supports n <= {FUSED_MAX_N}; got n={n} — "
            f"run staged (fused=False)")


def fused_from_table(cfg, n: int, *, from_x: bool = True):
    """The fused lazy top-K body starting after the candidate table (the
    reference's ``fused_from_table``): for callers that build the (n, K)
    table themselves, as the sharded funnel does
    (``core/distributed.py``, DESIGN.md §17.4), and for :func:`fused_one`,
    so both run one body.

    Returns ``tail(table, src) -> dict`` with :func:`fused_one`'s keys;
    ``table`` is the (values (n, K), indices (n, K)) pair and ``src`` the
    standardized series (``from_x=True``) or the dense similarity, as
    ``sparse_lazy_tmfg`` takes them.  The tail drops its reference to the
    table once the TMFG is built, so a caller that passes it as a
    temporary holds no table during the DBHT stage.  Raises for a config
    other than lazy top-K and above ``FUSED_MAX_N``, as the reference."""
    if cfg.similarity != "topk" or cfg.method != "lazy":
        raise ValueError(
            "fused_from_table is the lazy topk tail; got "
            f"similarity={cfg.similarity!r} method={cfg.method!r}")
    _check_n(n)
    sparse = use_sparse_tail(cfg, n)

    def tail(table, src: torch.Tensor):
        st = {}
        tm, w_sim, counters = sparse_tmfg_mod.sparse_lazy_tmfg(
            table[0], table[1], src, from_x=from_x, stats=st)
        del table
        if sparse:
            core = _sparse_tail(cfg, n, tm, w_sim)
        else:
            S = adjacency_from_weights(n, tm.edges, w_sim) if from_x \
                else src
            core, rounds = dbht_mod.dense_tail(S, tm, cfg)
            core.update(hubs=None, overflow=False, bf_rounds=rounds)
        core.update(tmfg=tm, counters=counters,
                    tmfg_host_syncs=st["host_syncs"])
        return core

    return tail


def fused_one(cfg, have_S: bool, n: int):
    """The single-matrix body for ``cfg`` (``similarity="topk"`` or
    ``apsp_method="sparse"``; see the module docstring).

    Returns ``one(arr) -> dict`` with ``dbht.dense_tail``'s keys plus
    tmfg, hubs, overflow, counters (None off the lazy approx body),
    bf_rounds and tmfg_host_syncs (after an overflow all of these but
    hubs, and nothing else); ``arr`` is X (n, L) or, with ``have_S``,
    S (n, n), on the run's device.  The lazy top-K branch is
    :func:`fused_from_table` after the table."""
    _check_n(n)
    sparse = use_sparse_tail(cfg, n)

    def tail(S_full, tm, w_sim):
        """The sparse tail on the edge values, or the dense tail on the
        (n, n) similarity ``S_full()``."""
        if sparse:
            return _sparse_tail(cfg, n, tm, w_sim)
        core, rounds = dbht_mod.dense_tail(S_full(), tm, cfg)
        core.update(hubs=None, overflow=False, bf_rounds=rounds)
        return core

    def built(S, st):
        """TMFG by ``cfg.method`` on a dense S; its edges' S values."""
        tm, syncs = _build(S, cfg.method, cfg.prefix, cfg.topk,
                              cfg.backend)
        st["host_syncs"] = syncs
        e = tm.edges.long()
        return tm, S[e[:, 0], e[:, 1]]

    def one(arr: torch.Tensor):
        st = {}
        if cfg.similarity != "topk":
            S = arr.float() if have_S else ops.pearson(arr,
                                                       backend=cfg.backend)
            tm, w_sim = built(S, st)
            core = _sparse_tail(cfg, n, tm, w_sim)
        else:
            kk = min(cfg.sim_k, n - 1)
            if cfg.method == "lazy":
                # the table is the tail's argument alone, freed once the
                # TMFG is built
                lazy = fused_from_table(cfg, n, from_x=not have_S)
                if have_S:
                    S = arr.float()
                    return lazy(knn_mod.topk_from_similarity(S, kk), S)
                return lazy(knn_mod.topk_pearson(arr, kk,
                                                 backend=cfg.backend),
                            standardize_rows(arr))
            if have_S:
                table = knn_mod.topk_from_similarity(arr.float(), kk)
            else:
                table = knn_mod.topk_pearson(arr, kk, backend=cfg.backend)
            # non-lazy methods run on the densified table (§13.3)
            Sd = knn_mod.densify(table, n=n)
            del table
            tm, w_sim = built(Sd, st)
            core = tail(lambda: Sd, tm, w_sim)
        core.update(tmfg=tm, counters=None,
                    tmfg_host_syncs=st["host_syncs"])
        return core

    return one
