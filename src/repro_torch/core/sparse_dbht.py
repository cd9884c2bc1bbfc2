"""Sparse DBHT tail: bubble flow and the nested HAC from the hub factor.

The port of ``repro.core.sparse_dbht`` (DESIGN.md §14.3, §14.4,
§14.5).  The dense DBHT stage (``core/dbht.py``) consumes an (n, n)
distance matrix; this tail derives every step from the TMFG's edge list
and the hub factor ``D_h`` (h, n) of ``apsp.hub_factor_sparse``, so
(n, n) is never formed.  Any distance is composed where it is needed:

    D~[u, v] = min( min_h D_h[h, u] + D_h[h, v],          # through a hub
                    w(u, v) if (u, v) is a TMFG edge,     # the edge floor
                    0 if u == v )

which is bitwise the (n, n) matrix :func:`densify` builds: a minimum is
exact and every sum rounds the same wherever it is taken.

Stages of :func:`dbht_sparse` (the staged form; the fused approx body,
``core/fused_approx.py``, shares stages 3 and 4):

  1. directions -- the host oracle's float64 side strengths as
     ``np.bincount`` folds in the oracle's term order, so the ±1
     directions are bitwise ``dbht._edge_directions``';
  2. flow -- the oracle's ``_flow_to_converging`` walk;
  3. one sweep of (PANEL_ROWS, n) panels of D~ (``ops.minplus``): the
     fine assignment, the global ``dmax`` and the (C, C) cross-cluster
     maxima, all from each panel;
  4. the nested HAC (:func:`nested_linkage`): one complete linkage per
     coarse cluster on its composed block (``hac.complete_linkage``:
     ``ops.masked_argmax``), or, above ``hac_max`` members, the
     bubble-tree linkage of DESIGN.md §14.4; one run over the clusters;
     the assembly of the (n-1, 4) linkage.

Why the per-cluster runs and the run over clusters make the oracle's one
global run: the hierarchical offsets put every cross-cluster pair at
>= 8 dmax and every intra-cluster pair at <= 3 dmax, so every intra
merge comes first; a cluster's members are ascending, so its local flat
index order is the global one; after the intra merges each cluster's
surviving row is the cross-cluster maxima, in the order of its smallest
member.  Complete-linkage heights are monotone, so a stable sort by
height restores the oracle's order, except where two clusters have
merges of exactly equal height (the reference's caveat, DESIGN.md §14.5).

Where the port's shapes differ from the reference's and the result does
not: a cluster's block is sized to its members, not padded to a power
of two (the padded rows sit at +inf and merge after every real one);
the sums over hubs are min-plus products, whose minimum does not depend
on the order.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.sparse_apsp import CSRGraph, csr_from_edges

from . import apsp as apsp_mod
from . import dbht as dbht_mod
from . import hac as hac_mod

INF = float("inf")

# The largest cluster whose linkage is an exact (m, m) block; above it the
# bubble-tree linkage takes over (DESIGN.md §14.4): exact inside each fine
# bubble, then the bubbles merge along their basin's tree edges.
SPARSE_EXACT_HAC_MAX = 4096

# rows per panel of the composed-distance sweep
PANEL_ROWS = 512


def edge_lengths_from_sim(w_sim: torch.Tensor) -> torch.Tensor:
    """sqrt(2 (1 - rho)) per edge, ``apsp.edge_lengths``' transform: the
    sqrt taken in float64 and rounded once (correctly rounded on every
    device, as XLA's)."""
    rho = torch.clamp(w_sim.float(), -1.0, 1.0)
    return torch.sqrt(torch.clamp(2.0 * (1.0 - rho), min=0.0)
                      .double()).float()


# ---------------------------------------------------------------------------
# stage 1: edge directions (host float64, bitwise the oracle's sums)
# ---------------------------------------------------------------------------

def _directions_sparse(edges: np.ndarray, w_sim: np.ndarray,
                       bubble_parent: np.ndarray, bubble_tri: np.ndarray,
                       home_bubble: np.ndarray,
                       chunk: int = 8192) -> np.ndarray:
    """``dbht._edge_directions`` from the edge list, vectorized.

    The oracle adds, per tree edge b, per triangle corner v (in triangle
    order), per TMFG neighbour u of v (in edge-list order), the float64
    similarity of (v, u) to the child or the parent side.  The terms are
    laid out here in that same (b, corner, neighbour) order and folded
    by ``np.bincount``, a sequential sum, so both sides and every
    comparison are bitwise the oracle's."""
    B = bubble_parent.shape[0]
    direction = np.zeros(B, np.int64)
    if B <= 1:
        return direction
    tin, tout = dbht_mod.euler_tour(bubble_parent)
    home_tin = tin[home_bubble]

    E = edges.shape[0]
    w64 = np.asarray(w_sim, np.float64)
    src = np.concatenate([edges[:, 0], edges[:, 1]]).astype(np.int64)
    dst = np.concatenate([edges[:, 1], edges[:, 0]]).astype(np.int64)
    wd = np.concatenate([w64, w64])
    eidx = np.concatenate([np.arange(E), np.arange(E)])
    order = np.lexsort((eidx, src))            # adj[v]: neighbours by edge id
    src, dst, wd = src[order], dst[order], wd[order]
    n = home_bubble.shape[0]
    start = np.searchsorted(src, np.arange(n))
    deg = np.searchsorted(src, np.arange(n), side="right") - start

    for b0 in range(1, B, chunk):
        b1 = min(b0 + chunk, B)
        corners = bubble_tri[b0:b1]            # (nb, 3)
        g_start = start[corners].reshape(-1)   # (3 nb,) in (b, corner) order
        g_len = deg[corners].reshape(-1)
        offs = np.concatenate([[0], np.cumsum(g_len)])
        total = int(offs[-1])
        if total == 0:
            continue
        idx = (np.repeat(g_start - offs[:-1], g_len)
               + np.arange(total, dtype=np.int64))
        owner = np.repeat(np.arange(b0, b1).repeat(3), g_len)
        t_dst, t_w = dst[idx], wd[idx]
        t0, t1, t2 = bubble_tri[owner].T
        in_tri = (t_dst == t0) | (t_dst == t1) | (t_dst == t2)
        ht = home_tin[t_dst]
        child = (ht >= tin[owner]) & (ht < tout[owner])
        s_child = np.bincount(owner, np.where(~in_tri & child, t_w, 0.0),
                              minlength=B)
        s_parent = np.bincount(owner, np.where(~in_tri & ~child, t_w, 0.0),
                               minlength=B)
        sl = slice(b0, b1)
        direction[sl] = np.where(s_child[sl] >= s_parent[sl], 1, -1)
    return direction


# ---------------------------------------------------------------------------
# stage 3: the composed-distance sweep (device)
# ---------------------------------------------------------------------------

def _sweep_panels(D_h: torch.Tensor, graph: CSRGraph,
                  bv: torch.Tensor, bubble_cluster: torch.Tensor,
                  cluster_of: torch.Tensor, C: int, backend: str,
                  bm: int = PANEL_ROWS):
    """Fine assignment (n,) int32, dmax and the (C, C) cross-cluster
    maxima from (bm, n) panels of D~ -- the reference's per-panel
    arithmetic (the 4-vertex means in its association, the lowest bubble
    on ties)."""
    h, n = D_h.shape
    dev = D_h.device
    bvl = bv.long()
    indptr_h = graph.indptr.cpu().numpy()
    rows_csr, cols_csr = graph.rows.long(), graph.cols.long()
    cl_all = cluster_of.long()
    bubble_of = torch.empty(n, dtype=torch.int32, device=dev)
    pmax = torch.full((), -INF, dtype=torch.float32, device=dev)
    ccm = torch.full((C, C), -INF, dtype=torch.float32, device=dev)
    for r0 in range(0, n, bm):
        r1 = min(r0 + bm, n)
        m = r1 - r0
        P = ops.minplus(D_h[:, r0:r1].T.contiguous(), D_h, backend=backend)
        e0, e1 = int(indptr_h[r0]), int(indptr_h[r1])   # the panel's rows
        pr, pc = rows_csr[e0:e1] - r0, cols_csr[e0:e1]
        P[pr, pc] = torch.minimum(P[pr, pc], graph.vals[e0:e1])
        ar = torch.arange(m, device=dev)
        P[ar, ar + r0] = 0.0
        # ((P[:, b0] + P[:, b1]) + P[:, b2]) + P[:, b3], the reference's
        # association, accumulated in place into one (m, B) buffer
        md = P.index_select(1, bvl[:, 0])
        for c in (1, 2, 3):
            md += P.index_select(1, bvl[:, c])
        md /= 4.0
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
# stage 4a: the exact linkage of one cluster (device)
# ---------------------------------------------------------------------------

def _cluster_entries(graph: CSRGraph, cluster_h: np.ndarray,
                     local_h: np.ndarray, C: int, dev):
    """CSR entries with both ends in one cluster, grouped by cluster:
    (per-cluster entry offsets on the host, local row, local col, value)."""
    rows = graph.rows.cpu().numpy()
    cols = graph.cols.cpu().numpy()
    cr = cluster_h[rows]
    keep = np.nonzero(cr == cluster_h[cols])[0]
    keep = keep[np.argsort(cr[keep], kind="stable")]
    starts = np.searchsorted(cr[keep], np.arange(C + 1))
    li = torch.from_numpy(local_h[rows[keep]]).to(dev)
    lj = torch.from_numpy(local_h[cols[keep]]).to(dev)
    vals = graph.vals[torch.from_numpy(keep).to(dev)]
    return starts, li, lj, vals


def _cluster_linkage(D_h, members, li, lj, vals, bloc, m1, backend):
    """Complete linkage of one cluster's composed block with the
    cross-bubble offset: (m-1, 4) rows with local ids (leaf < m, merge r
    makes m + r)."""
    A = D_h[:, members]                                      # (h, m)
    Dc = ops.minplus(A.T.contiguous(), A, backend=backend)   # min over hubs
    Dc[li, lj] = torch.minimum(Dc[li, lj], vals)             # edge floor
    Dc.fill_diagonal_(0.0)
    cross = bloc[:, None] != bloc[None, :]
    adj = Dc + torch.where(cross, m1, 0.0)                   # oracle's order
    return hac_mod.complete_linkage(adj, backend=backend)


# ---------------------------------------------------------------------------
# stage 4b: the bubble-tree linkage of an oversized cluster (host)
# ---------------------------------------------------------------------------

def _edge_lookup(csr_keys: np.ndarray, csr_vals: np.ndarray, n: int,
                 u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Direct-edge lengths for vertex pairs (inf when not a TMFG edge)."""
    key = u.astype(np.int64) * n + v.astype(np.int64)
    pos = np.searchsorted(csr_keys, key)
    pos = np.minimum(pos, csr_keys.shape[0] - 1)
    hit = csr_keys[pos] == key
    return np.where(hit, csr_vals[pos], np.float32(np.inf)).astype(np.float32)


def _np_complete_linkage(D: np.ndarray) -> np.ndarray:
    """Host complete linkage with the flat-argmin tie order (the small
    intra-bubble blocks of the tree mode)."""
    m = D.shape[0]
    D = D.astype(np.float32).copy()
    np.fill_diagonal(D, np.inf)
    ids = np.arange(m)
    sizes = np.ones(m, np.int64)
    alive = np.ones(m, bool)
    Z = np.zeros((m - 1, 4), np.float32)
    for k in range(m - 1):
        big = np.where(alive[:, None] & alive[None, :], D, np.inf)
        flat = int(np.argmin(big))
        i, j = flat // m, flat % m
        i, j = min(i, j), max(i, j)
        Z[k] = (ids[i], ids[j], big[i, j], sizes[i] + sizes[j])
        row = np.maximum(D[i], D[j])
        D[i, :] = row
        D[:, i] = row
        D[i, i] = np.inf
        alive[j] = False
        ids[i] = m + k
        sizes[i] += sizes[j]
    return Z


def _rep_dist(D_h: torch.Tensor, bv: torch.Tensor,
              parent: torch.Tensor) -> torch.Tensor:
    """(B-1, 4, 4): for each bubble-tree edge, the hub-composed distance
    between every defining vertex of the child and of the parent, 0
    where the two are one vertex (without the edge floor)."""
    pc = bv[1:].long()
    pp = bv.index_select(0, parent[1:].long()).long()
    acc = torch.full((pc.shape[0], 4, 4), INF, dtype=torch.float32,
                     device=D_h.device)
    for row in D_h:                                          # min over hubs
        acc = torch.minimum(acc, row[pc][:, :, None] + row[pp][:, None, :])
    return torch.where(pc[:, :, None] == pp[:, None, :], 0.0, acc)


def _tree_cluster_rows(D_h_np, members, basin, bubble_of, rep_plus_m1,
                       bubble_parent, csr_keys, csr_vals, n):
    """Approximate linkage of one oversized cluster (DESIGN.md §14.4).

    Intra-(fine-)bubble merges are exact complete linkage on composed
    blocks; bubbles then merge along their basin's spanning subtree of
    the bubble tree in ascending rep-distance order (heights clamped
    monotone).  Returns a list of (height, left_ref, right_ref) rows
    where a ref is ('v', vertex) or ('r', local row index).
    """
    rows: List[Tuple[np.float32, tuple, tuple]] = []
    root_ref = {}                      # bubble id -> ref of its subtree root
    root_h = {}                        # bubble id -> height of that root
    by_bubble: dict = {}
    for v in members:
        by_bubble.setdefault(int(bubble_of[v]), []).append(int(v))

    for b, verts in by_bubble.items():
        verts = np.asarray(sorted(verts))
        m = verts.shape[0]
        if m == 1:
            root_ref[b] = ("v", int(verts[0]))
            root_h[b] = np.float32(0.0)
            continue
        A = D_h_np[:, verts]                                # (h, m)
        Dc = np.min(A[:, :, None] + A[:, None, :], axis=0)
        iu, ju = np.triu_indices(m, 1)
        w = _edge_lookup(csr_keys, csr_vals, n, verts[iu], verts[ju])
        Dc[iu, ju] = np.minimum(Dc[iu, ju], w)
        Dc[ju, iu] = Dc[iu, ju]
        np.fill_diagonal(Dc, 0.0)
        Z = _np_complete_linkage(Dc)
        base = len(rows)
        for k in range(m - 1):
            l, r = int(Z[k, 0]), int(Z[k, 1])
            lref = ("v", int(verts[l])) if l < m else ("r", base + l - m)
            rref = ("v", int(verts[r])) if r < m else ("r", base + r - m)
            rows.append((np.float32(Z[k, 2]), lref, rref))
        root_ref[b] = ("r", base + m - 2)
        root_h[b] = np.float32(Z[m - 2, 2])

    # Kruskal over the basin's bubble-tree edges by rep distance
    basin_set = set(int(b) for b in basin)
    tree_edges = [(rep_plus_m1[b - 1], b, int(bubble_parent[b]))
                  for b in basin_set
                  if b >= 1 and int(bubble_parent[b]) in basin_set]
    tree_edges.sort(key=lambda t: float(t[0]))
    uf = {b: b for b in basin_set}

    def find(x):
        while uf[x] != x:
            uf[x] = uf[uf[x]]
            x = uf[x]
        return x

    for hgt, b, p in tree_edges:
        rb, rp = find(b), find(p)
        if rb == rp:
            continue
        uf[rp] = rb
        has_b, has_p = rb in root_ref, rp in root_ref
        if has_b and has_p:
            h_eff = np.float32(max(hgt, root_h[rb], root_h[rp]))
            rows.append((h_eff, root_ref[rb], root_ref[rp]))
            root_ref[rb] = ("r", len(rows) - 1)
            root_h[rb] = h_eff
            del root_ref[rp], root_h[rp]
        elif has_p:                     # empty side unions silently
            root_ref[rb] = root_ref.pop(rp)
            root_h[rb] = root_h.pop(rp)
    return rows


def _local_rows(rows, members: np.ndarray) -> np.ndarray:
    """Tree-mode rows in the local ids of the exact blocks: a vertex is
    its position among the (ascending) members, row r is m + r."""
    m = members.shape[0]
    z = np.zeros((len(rows), 4), np.float32)
    for j, (hgt, lref, rref) in enumerate(rows):
        for col, (kind, val) in ((0, lref), (1, rref)):
            z[j, col] = (np.searchsorted(members, val) if kind == "v"
                         else m + val)
        z[j, 2] = hgt
    return z


class _Tree:
    """What the bubble-tree linkage needs, gathered once per tail."""

    def __init__(self, D_h, graph, tm, bubble_cluster_h, bubble_of, C,
                 m1: np.float32):
        n = graph.n
        parent_h, bv_h = tm["bubble_parent"], tm["bubble_verts"]
        B = parent_h.shape[0]
        self.n, self.parent = n, parent_h
        b_order = np.argsort(bubble_cluster_h, kind="stable")
        b_bounds = np.searchsorted(bubble_cluster_h[b_order],
                                   np.arange(C + 1))
        self.basin_of = {c: b_order[b_bounds[c]:b_bounds[c + 1]]
                         for c in range(C)}
        rows = graph.rows.cpu().numpy().astype(np.int64)
        cols = graph.cols.cpu().numpy().astype(np.int64)
        self.csr_keys = rows * n + cols              # ascending (CSR order)
        self.csr_vals = graph.vals.cpu().numpy()
        self.rep_plus_m1 = None
        if B > 1:
            dev = D_h.device
            rep = _rep_dist(D_h, torch.from_numpy(bv_h).to(dev),
                            torch.from_numpy(parent_h).to(dev)).cpu().numpy()
            child = np.arange(1, B)
            pc, pp = bv_h[child], bv_h[parent_h[child]]
            for i in range(4):
                for j in range(4):
                    w = _edge_lookup(self.csr_keys, self.csr_vals, n,
                                     pc[:, i], pp[:, j])
                    rep[:, i, j] = np.minimum(rep[:, i, j], w)
            self.rep_plus_m1 = rep.max(axis=(1, 2)).astype(np.float32) + m1
        self.D_h = D_h.cpu().numpy()
        self.bubble_of = bubble_of.cpu().numpy()

    def rows(self, c: int, members: np.ndarray) -> np.ndarray:
        return _local_rows(_tree_cluster_rows(
            self.D_h, members, self.basin_of[c], self.bubble_of,
            self.rep_plus_m1, self.parent, self.csr_keys, self.csr_vals,
            self.n), members)


# ---------------------------------------------------------------------------
# stage 4: the nested HAC and the assembly
# ---------------------------------------------------------------------------

def _assemble_linkage(n: int, slot_rows, slot_members, Zt) -> np.ndarray:
    """The (n-1, 4) linkage from each cluster's rows (local ids, clusters
    in slot order) and the rows of the run over the slots, as the
    reference assembles it: intra rows stably sorted by height in
    slot-major order, the top rows after them, ids resolved through that
    order, sizes recomputed bottom-up."""
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


def nested_linkage(D_h: torch.Tensor, graph: CSRGraph, tm,
                   cluster_h: np.ndarray, bubble_cluster_h: np.ndarray,
                   bubble_of: torch.Tensor, C: int, dmax: torch.Tensor,
                   ccm: torch.Tensor, *, backend: str,
                   hac_max: int = SPARSE_EXACT_HAC_MAX) -> torch.Tensor:
    """The (n-1, 4) linkage of the nested HAC, on D_h's device.

    One complete linkage per coarse cluster on its composed block (the
    tree linkage above ``hac_max`` members), in the order of each
    cluster's smallest member, and one over the clusters on the
    cross-cluster maxima ``ccm`` with the oracle's two-add offset.
    ``tm`` holds the TMFG's host arrays (``dbht.host_tmfg``), needed in
    the tree mode only."""
    n = D_h.shape[1]
    dev = D_h.device
    m1 = 2.0 * dmax                                  # float32, the oracle's
    off2 = 8.0 * dmax - m1
    counts = np.bincount(cluster_h, minlength=C)
    v_order = np.argsort(cluster_h, kind="stable")   # members ascending
    bounds = np.concatenate([[0], np.cumsum(counts)])
    nonempty = np.flatnonzero(counts)
    perm = nonempty[np.argsort(v_order[bounds[nonempty]], kind="stable")]
    local_h = np.empty(n, np.int64)
    local_h[v_order] = np.arange(n) - bounds[cluster_h[v_order]]
    starts, li, lj, vals = _cluster_entries(graph, cluster_h, local_h, C,
                                            dev)
    tree = (_Tree(D_h, graph, tm, bubble_cluster_h, bubble_of, C,
                  np.float32(m1.item()))
            if int(counts.max()) > hac_max else None)

    v_order_d = torch.from_numpy(v_order).to(dev)
    slot_rows: List[np.ndarray] = []
    slot_members, on_dev = [], []
    for c in perm:
        b0, b1 = int(bounds[c]), int(bounds[c + 1])
        members = v_order[b0:b1]
        slot_members.append(members)
        slot_rows.append(np.zeros((0, 4), np.float32))
        if b1 - b0 <= 1:
            continue
        if b1 - b0 > hac_max:
            slot_rows[-1] = tree.rows(int(c), members)
            continue
        e0, e1 = int(starts[c]), int(starts[c + 1])
        md = v_order_d[b0:b1]
        on_dev.append((len(slot_rows) - 1, _cluster_linkage(
            D_h, md, li[e0:e1], lj[e0:e1], vals[e0:e1],
            bubble_of.index_select(0, md), m1, backend)))
    if on_dev:                                       # one copy for all
        host = torch.cat([z for _, z in on_dev]).cpu().numpy()
        r0 = 0
        for s, z in on_dev:
            slot_rows[s] = host[r0:r0 + z.shape[0]]
            r0 += z.shape[0]

    Zt = np.zeros((0, 4), np.float32)
    if len(perm) > 1:
        pd = torch.from_numpy(perm).to(dev)
        ccm_p = ccm.index_select(0, pd).index_select(1, pd)
        top_adj = (torch.maximum(ccm_p, ccm_p.T) + m1) + off2
        Zt = hac_mod.complete_linkage(top_adj, backend=backend).cpu().numpy()
    return torch.from_numpy(
        _assemble_linkage(n, slot_rows, slot_members, Zt)).to(dev)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def densify(D_h: torch.Tensor, graph: CSRGraph, *,
            backend: str = "auto") -> torch.Tensor:
    """(n, n) D~ from the hub factor: what the panels and cluster blocks
    compose, bitwise, and what the host oracle takes as its APSP.  It is
    the (n, n) buffer the tail exists to avoid: parity use only."""
    n = graph.n
    W = torch.full((n, n), INF, dtype=torch.float32, device=D_h.device)
    W[graph.rows.long(), graph.cols.long()] = graph.vals
    W.fill_diagonal_(0.0)
    est = ops.minplus(D_h.T.contiguous(), D_h, backend=backend)
    torch.minimum(est, W, out=est)
    del W
    est = torch.minimum(est, est.T)
    est.fill_diagonal_(0.0)
    return est


def tmfg_adj_sim(n: int, edges: np.ndarray, w_sim: np.ndarray) -> np.ndarray:
    """Dense similarity adjacency from edge weights (host; the oracle's
    input only -- the tail itself never builds it)."""
    S = np.zeros((n, n), np.float32)
    S[edges[:, 0], edges[:, 1]] = w_sim
    S[edges[:, 1], edges[:, 0]] = w_sim
    np.fill_diagonal(S, 1.0)
    return S


def dbht_sparse(S, tmfg, *, edge_weights=None, n_hubs: int = 0,
                rounds: int = 0, backend: str = "auto", impl: str = "device",
                bm: int = PANEL_ROWS, hac_max: int = SPARSE_EXACT_HAC_MAX,
                done=dbht_mod._no_stage, stats: dict = None):
    """DBHT from the TMFG edge list and the hub factor; never (n, n).

    ``S`` (a tensor or an array) may be None when ``edge_weights`` (the
    similarity of each TMFG edge, (3n-6,)) is given: the staged sparse
    pipeline passes the weights it built the TMFG from.  ``impl="host"``
    densifies the factor and runs the numpy oracle
    (``dbht._dbht_host``): the parity reference, not a production path.
    Returns a ``DBHTResult`` on the TMFG's device whose ``apsp`` is the
    hub factor D_h (h, n) and ``hubs`` its hub ids.  ``done(stage)`` is
    called after "apsp", "dbht" and "hac"; ``stats``, if a dict, receives
    ``bf_rounds``.
    """
    dev = tmfg.edges.device
    n = tmfg.home_bubble.shape[0]
    if edge_weights is None:
        if S is None:
            raise ValueError("dbht_sparse needs S or edge_weights")
        e = tmfg.edges.long()
        w_sim = dbht_mod._as_f32(S, dev)[e[:, 0], e[:, 1]]
    else:
        w_sim = dbht_mod._as_f32(edge_weights, dev)
    graph = csr_from_edges(n, tmfg.edges, edge_lengths_from_sim(w_sim))
    hubs, D_h = apsp_mod.hub_factor_sparse(graph, n_hubs=n_hubs,
                                           rounds=rounds, backend=backend,
                                           stats=stats)
    tm = dbht_mod.host_tmfg(tmfg)
    w_h = w_sim.cpu().numpy()
    if impl == "host":
        return dbht_mod._dbht_host(
            S if S is not None else tmfg_adj_sim(n, tm["edges"], w_h),
            tmfg, apsp_method="sparse", apsp_backend=backend,
            precomputed_apsp=densify(D_h, graph, backend=backend),
            done=done)
    if impl != "device":
        raise ValueError(f"unknown DBHT impl {impl!r}")
    done("apsp")

    # stages 1-2: directions and flow (host, bitwise the oracle's)
    direction = _directions_sparse(tm["edges"], w_h, tm["bubble_parent"],
                                   tm["bubble_tri"], tm["home_bubble"])
    dest, converging = dbht_mod._flow_to_converging(tm["bubble_parent"],
                                                    direction)
    conv_index = {int(c): i for i, c in enumerate(converging)}
    bubble_cluster_h = np.array([conv_index[int(d)] for d in dest],
                                dtype=np.int64)
    cluster_h = bubble_cluster_h[tm["home_bubble"]]
    C = converging.shape[0]
    cluster_of = torch.from_numpy(cluster_h).to(dev)

    # stage 3: one sweep of D~
    bubble_of, dmax, ccm = _sweep_panels(
        D_h, graph, tmfg.bubble_verts,
        torch.from_numpy(bubble_cluster_h).to(dev), cluster_of, C, backend,
        bm)
    done("dbht")

    # stage 4: the nested HAC
    Z = nested_linkage(D_h, graph, tm, cluster_h, bubble_cluster_h,
                       bubble_of, C, dmax, ccm, backend=backend,
                       hac_max=hac_max)
    done("hac")
    return dbht_mod.DBHTResult(
        linkage=Z, cluster_of=cluster_of, bubble_of=bubble_of,
        converging=torch.from_numpy(converging).to(dev),
        direction=torch.from_numpy(direction[1:]).to(dev), apsp=D_h,
        hubs=hubs.int())
