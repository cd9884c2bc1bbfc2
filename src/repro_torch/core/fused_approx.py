"""The approx pipeline's default (fused) body: no (n, n) buffer.

The port of ``repro.core.fused_approx`` (DESIGN.md §17) for the lazy
top-K configuration, ``PipelineConfig.approx()``.  The reference traces
the whole path into one program over static shapes; the port runs the
same stages eagerly, in the same order, with the same arithmetic:

  top-K Pearson table (``ops.topk``, the CUDA kernel on the card)
  → lazy sparse TMFG on the table (``approx/sparse_tmfg.py``)
  → CSR of the TMFG edge lengths and the hub factor D_h (h, n)
    (``apsp.hub_factor_sparse``: ``ops.sparse_relax``, the CUDA kernel)
  → bubble-tree directions from the edge list (prefix sums, below)
  → converging flow, and a sweep of (512, n) panels of the composed
    distances ``min(min_h D_h[h, u] + D_h[h, v], edge)`` (``ops.minplus``)
  → one complete linkage per coarse cluster on its composed block
    (``hac.complete_linkage``: ``ops.masked_argmax``, the CUDA kernel),
    one over the clusters, and the assembly of the (n-1, 4) linkage.

Below ``HUB_MIN_N`` the same table and TMFG feed the dense tail the
staged path runs (exact APSP, device DBHT).

Where the port departs from the reference's shapes, and why the result
does not change:

  * the reference's slot grid (power-of-two member tiers for
    ``lax.switch``) becomes one block per cluster sized to its members:
    the real merges of a tier-padded block are those of the unpadded one;
  * the sums over hubs in the panel sweep and in each cluster's block
    are min-plus products ``minplus(D_h[:, rows].T, D_h)``: a minimum of
    exactly rounded sums does not depend on the order;
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
``cluster()`` then reruns the staged path, as the reference does.
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
from repro_torch.kernels.sparse_apsp import CSRGraph, csr_from_edges

from . import apsp as apsp_mod
from . import dbht as dbht_mod
from . import hac as hac_mod
from .tmfg import TMFGResult, adjacency_from_weights

INF = float("inf")

# The reference's slot-grid caps (DESIGN.md §17.3): at most c_cap coarse
# clusters of at most m_cap members, c_cap = max(FUSED_C_CAP, 4 isqrt(n)).
FUSED_C_CAP = 64
FUSED_M_CAP = 2048

# the reference's int32 composite sort keys bound the fused path to
# n^2 < 2^31; the port keeps the bound so both packages take one input set
FUSED_MAX_N = 46_340

# rows per panel of the composed-distance sweep
PANEL_ROWS = 512


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
    """The sparse tail runs for the lazy approx default at the sizes where
    the staged path would run hub APSP (n >= HUB_MIN_N)."""
    if cfg.apsp_method == "sparse":
        return True
    return (cfg.similarity == "topk" and cfg.method == "lazy"
            and cfg.apsp_method == "hub" and n >= apsp_mod.HUB_MIN_N)


# ---------------------------------------------------------------------------
# directions from the edge list (DESIGN.md §17.2)
# ---------------------------------------------------------------------------

def euler_tour(parent: np.ndarray):
    """Preorder (tin, tout) of the bubble tree with children in ascending
    id, tout = tin + subtree size: the reference's two loops, on the host.
    Parents have smaller ids than their children (insertion order)."""
    par = [int(x) for x in parent]
    B = len(par)
    size = [1] * B
    for b in range(B - 1, 0, -1):
        size[par[b]] += size[b]
    tin = [0] * B
    nxt = [0] * B
    nxt[0] = 1
    for b in range(1, B):
        p = par[b]
        t = nxt[p]
        tin[b] = t
        nxt[p] = t + size[b]
        nxt[b] = t + 1
    tin_a = np.asarray(tin, np.int64)
    return tin_a, tin_a + np.asarray(size, np.int64)


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
# the composed-distance sweep (DESIGN.md §17.1)
# ---------------------------------------------------------------------------

def _sweep_panels(D_h: torch.Tensor, graph: CSRGraph, indptr_h: np.ndarray,
                  bv: torch.Tensor, bubble_cluster: torch.Tensor,
                  cluster_of: torch.Tensor, C: int, backend: str):
    """Fine assignment (n,), dmax and the (C, C) cross-cluster maxima from
    (PANEL_ROWS, n) panels of
    D~[u, v] = min(min_h D_h[h, u] + D_h[h, v], w(u, v)), 0 on the
    diagonal -- the reference's per-panel arithmetic."""
    h, n = D_h.shape
    dev = D_h.device
    bvl = bv.long()
    rows_csr, cols_csr = graph.rows.long(), graph.cols.long()
    cl_all = cluster_of.long()
    bubble_of = torch.empty(n, dtype=torch.int32, device=dev)
    pmax = torch.full((), -INF, dtype=torch.float32, device=dev)
    ccm = torch.full((C, C), -INF, dtype=torch.float32, device=dev)
    for r0 in range(0, n, PANEL_ROWS):
        r1 = min(r0 + PANEL_ROWS, n)
        m = r1 - r0
        P = ops.minplus(D_h[:, r0:r1].T.contiguous(), D_h, backend=backend)
        e0, e1 = int(indptr_h[r0]), int(indptr_h[r1])   # the panel's rows
        pr, pc = rows_csr[e0:e1] - r0, cols_csr[e0:e1]
        P[pr, pc] = torch.minimum(P[pr, pc], graph.vals[e0:e1])
        ar = torch.arange(m, device=dev)
        P[ar, ar + r0] = 0.0
        md = (((P[:, bvl[:, 0]] + P[:, bvl[:, 1]]) + P[:, bvl[:, 2]])
              + P[:, bvl[:, 3]]) / 4.0                         # (m, B)
        cl = cl_all[r0:r1]
        same = bubble_cluster[None, :] == cl[:, None]
        bubble_of[r0:r1] = md.masked_fill_(~same, INF).argmin(dim=1).int()
        del md, same
        pmax = torch.maximum(pmax, P.max())
        colmax = torch.full((m, C), -INF, dtype=torch.float32, device=dev)
        colmax.scatter_reduce_(1, cl_all.expand(m, n), P, "amax")
        ccm_p = torch.full((C, C), -INF, dtype=torch.float32, device=dev)
        ccm_p.scatter_reduce_(0, cl[:, None].expand(m, C), colmax, "amax")
        torch.maximum(ccm, ccm_p, out=ccm)
    return bubble_of, pmax + 1.0, ccm


# ---------------------------------------------------------------------------
# nested HAC: one block per cluster, one run over clusters, assembly
# ---------------------------------------------------------------------------

def _cluster_entries(graph: CSRGraph, cluster_h: np.ndarray,
                     local_h: np.ndarray, dev):
    """CSR entries with both ends in one cluster, grouped by cluster:
    (per-cluster entry offsets on the host, local row, local col, value)."""
    rows = graph.rows.cpu().numpy()
    cols = graph.cols.cpu().numpy()
    cr = cluster_h[rows]
    keep = np.nonzero(cr == cluster_h[cols])[0]
    keep = keep[np.argsort(cr[keep], kind="stable")]
    starts = np.searchsorted(cr[keep], np.arange(int(cluster_h.max()) + 2))
    li = torch.from_numpy(local_h[rows[keep]]).to(dev)
    lj = torch.from_numpy(local_h[cols[keep]]).to(dev)
    vals = graph.vals[torch.from_numpy(keep).to(dev)]
    return starts, li, lj, vals


def _cluster_linkage(D_h, members, li, lj, vals, bloc, m1, backend):
    """Complete linkage of one cluster's composed block with the
    cross-bubble offset: (m-1, 4) rows with local ids (leaf < m)."""
    A = D_h[:, members]                                      # (h, m)
    Dc = ops.minplus(A.T.contiguous(), A, backend=backend)   # min over hubs
    Dc[li, lj] = torch.minimum(Dc[li, lj], vals)             # edge floor
    Dc.fill_diagonal_(0.0)
    cross = bloc[:, None] != bloc[None, :]
    adj = Dc + torch.where(cross, m1, 0.0)
    return hac_mod.complete_linkage(adj, backend=backend)


def _assemble(n: int, slot_rows, slot_members, Zt: np.ndarray) -> np.ndarray:
    """The (n-1, 4) linkage from the per-cluster rows (in slot order) and
    the top rows over slots, as the reference assembles it: intra rows
    stably sorted by height in slot-major order, the top rows after them,
    ids resolved through that order, sizes recomputed bottom-up."""
    C = len(slot_rows)
    counts = [len(m) for m in slot_members]
    offs = np.concatenate([[0], np.cumsum([c - 1 for c in counts])])
    n_intra = int(offs[-1])
    heights = (np.concatenate([z[:, 2] for z in slot_rows])
               if n_intra else np.zeros(0, np.float32))
    order = np.argsort(heights, kind="stable")
    rank = np.empty(n_intra, np.int64)
    rank[order] = np.arange(n_intra)

    Z = np.zeros((n - 1, 4), np.float32)
    for s in range(C):
        z, mem, m = slot_rows[s], slot_members[s], counts[s]
        if m <= 1:
            continue
        ids = z[:, :2].astype(np.int64)
        res = np.where(ids < m, mem[np.minimum(ids, m - 1)],
                       n + rank[offs[s] + np.maximum(ids - m, 0)])
        tgt = rank[offs[s]:offs[s + 1]]
        Z[tgt, 0:2] = res
        Z[tgt, 2] = z[:, 2]
    for t in range(C - 1):
        out = []
        for ref in Zt[t, :2].astype(np.int64):
            if ref < C:
                s = int(ref)
                out.append(slot_members[s][0] if counts[s] <= 1
                           else n + rank[offs[s] + counts[s] - 2])
            else:
                out.append(n + n_intra + int(ref) - C)
        Z[n_intra + t, 0:2] = out
        Z[n_intra + t, 2] = Zt[t, 2]
    sizes = np.ones(2 * n - 1, np.int64)
    li, ri = Z[:, 0].astype(np.int64), Z[:, 1].astype(np.int64)
    for g in range(n - 1):
        sizes[n + g] = sizes[li[g]] + sizes[ri[g]]
    Z[:, 3] = sizes[n:]
    return Z


def _sparse_tail(cfg, n: int, tm: TMFGResult,
                 w_sim: torch.Tensor) -> Dict[str, object]:
    """TMFG edge list + per-edge similarities -> sparse DBHT outputs (the
    keys of ``dbht.dense_tail``'s dict plus hubs, overflow and
    bf_rounds).  Where the coarse clusters overflow the reference's slot
    caps it stops there and returns only overflow and bf_rounds."""
    dev = w_sim.device
    edges = tm.edges
    # the edge-length transform of apsp.edge_lengths: the sqrt in float64,
    # rounded once (correctly rounded on every device, as XLA's)
    rho = torch.clamp(w_sim.float(), -1.0, 1.0)
    w_len = torch.sqrt(torch.clamp(2.0 * (1.0 - rho), min=0.0)
                       .double()).float()
    graph = csr_from_edges(n, edges, w_len)
    stats = {}
    hubs, D_h = apsp_mod.hub_factor_sparse(
        graph, n_hubs=cfg.apsp_hubs, rounds=cfg.apsp_rounds,
        backend=cfg.backend, stats=stats)

    direction = _device_directions_sparse(
        n, edges, w_sim, tm.bubble_parent, tm.bubble_tri, tm.home_bubble)
    _, dest, conv_mask = dbht_mod._device_flow(tm.bubble_parent, direction)
    conv_id = torch.cumsum(conv_mask.to(torch.int32), 0,
                           dtype=torch.int32) - 1
    bubble_cluster = conv_id.index_select(0, dest)
    cluster_of = bubble_cluster.index_select(0, tm.home_bubble.long())

    cluster_h = cluster_of.cpu().numpy().astype(np.int64)
    C = int(cluster_h.max()) + 1
    counts = np.bincount(cluster_h, minlength=C)
    c_cap, m_cap = fused_caps(n)
    if C > c_cap or int(counts.max()) > m_cap:
        # the reference's overflow: its slot grid cannot hold these
        # clusters, and the caller reruns the staged path
        return dict(overflow=True, bf_rounds=stats["bf_rounds"])

    indptr_h = graph.indptr.cpu().numpy()
    bubble_of, dmax, ccm = _sweep_panels(
        D_h, graph, indptr_h, tm.bubble_verts, bubble_cluster, cluster_of,
        C, cfg.backend)
    m1 = 2.0 * dmax                                  # float32 tensors
    off2 = 8.0 * dmax - m1

    # members of each cluster ascending (a stable sort by cluster), the
    # clusters in order of their smallest member (the reference's slots)
    v_order = np.argsort(cluster_h, kind="stable")
    bounds = np.concatenate([[0], np.cumsum(counts)])
    perm = np.argsort(v_order[bounds[:-1]], kind="stable")
    local_h = np.empty(n, np.int64)
    local_h[v_order] = np.arange(n) - bounds[cluster_h[v_order]]

    starts, li, lj, vals = _cluster_entries(graph, cluster_h, local_h, dev)
    v_order_d = torch.from_numpy(v_order).to(dev)
    slot_rows, slot_members = [], []
    for c in perm:
        b0, b1 = int(bounds[c]), int(bounds[c + 1])
        members = v_order_d[b0:b1]
        slot_members.append(v_order[b0:b1])
        if b1 - b0 <= 1:
            slot_rows.append(np.zeros((0, 4), np.float32))
            continue
        e0, e1 = int(starts[c]), int(starts[c + 1])
        Zc = _cluster_linkage(D_h, members, li[e0:e1], lj[e0:e1],
                              vals[e0:e1], bubble_of.index_select(0, members),
                              m1, cfg.backend)
        slot_rows.append(Zc)
    slot_rows = [z if isinstance(z, np.ndarray) else z.cpu().numpy()
                 for z in slot_rows]

    # the run over clusters: cross-cluster maxima in slot order with the
    # two-add offset, the reference's flat-argmin form
    pd = torch.from_numpy(perm).to(dev)
    ccm_p = ccm.index_select(0, pd).index_select(1, pd)
    top_adj = (torch.maximum(ccm_p, ccm_p.T) + m1) + off2
    Zt = hac_mod.complete_linkage(top_adj, backend="torch").cpu().numpy()

    Z = _assemble(n, slot_rows, slot_members, Zt)
    return dict(direction=direction, conv_mask=conv_mask,
                cluster_of=cluster_of, bubble_of=bubble_of, D=D_h,
                Z=torch.from_numpy(Z).to(dev), hubs=hubs.int(),
                overflow=False, bf_rounds=stats["bf_rounds"])


def fused_one(cfg, have_S: bool, n: int):
    """The single-matrix approx body for ``cfg`` (lazy, similarity="topk").

    Returns ``one(arr) -> dict`` with ``dbht.dense_tail``'s keys plus
    tmfg, hubs, overflow, counters, bf_rounds and tmfg_host_syncs (after
    an overflow all of these but hubs, and nothing else); ``arr`` is
    X (n, L) or, with ``have_S``, S (n, n), on the run's device."""
    if cfg.similarity != "topk" or cfg.method != "lazy":
        raise ValueError(
            "the port's fused approx body is the lazy top-K path; got "
            f"similarity={cfg.similarity!r} method={cfg.method!r}")
    if n > FUSED_MAX_N:
        raise ValueError(
            f"fused approx path supports n <= {FUSED_MAX_N}; got n={n} — "
            f"run staged (fused=False)")
    sparse = use_sparse_tail(cfg, n)

    def one(arr: torch.Tensor):
        kk = min(cfg.sim_k, n - 1)
        if have_S:
            S = arr.float()
            table = knn_mod.topk_from_similarity(S, kk)
            src, from_x = S, False
        else:
            table = knn_mod.topk_pearson(arr, kk, backend=cfg.backend)
            src, from_x, S = standardize_rows(arr), True, None
        st = {}
        tm, w_edges, counters = sparse_tmfg_mod.sparse_lazy_tmfg(
            table.values, table.indices, src, from_x=from_x, stats=st)
        del table
        if sparse:
            core = _sparse_tail(cfg, n, tm, w_edges)
        else:
            S_use = S if S is not None else \
                adjacency_from_weights(n, tm.edges, w_edges)
            core, rounds = dbht_mod.dense_tail(S_use, tm, cfg)
            core.update(hubs=None, overflow=False, bf_rounds=rounds)
        core.update(tmfg=tm, counters=counters,
                    tmfg_host_syncs=st["host_syncs"])
        return core

    return one
