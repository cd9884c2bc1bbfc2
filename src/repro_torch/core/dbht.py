"""DBHT — Directed Bubble Hierarchy Tree clustering on a TMFG.

The port of ``repro.core.dbht`` (DESIGN.md §11).  Two strategies, as in
the reference, with the same outputs on the same inputs:

  * ``impl="device"`` (the default): the bubble-tree ancestry by pointer
    doubling, the edge directions as one (B, n) reduction, the
    converging-bubble flow by pointer jumping, the fine assignment as
    one masked (n, B) argmin, and the nested complete linkage on the
    offset-adjusted APSP matrix (``hac.hierarchical_offsets``).  Every
    step is a fixed-shape tensor program; nothing goes to the host until
    the result is unpacked.  The (n, n)-sized steps update in place where
    that saves a second (n, n) buffer; each such place says so.
  * ``impl="host"``: the reference's numpy tree walk (the parity oracle,
    :func:`_dbht_host`), with APSP and the one nested linkage still run
    on the device of the TMFG's tensors (``apsp.apsp``, ``ops.minplus``;
    ``hac.complete_linkage``, ``ops.masked_argmax``).

``apsp_method="sparse"`` routes to the edge-list tail
(``core/sparse_dbht.py``), which never forms (n, n); :func:`dbht_batch`
runs a batch of matrices one entry after another.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from . import apsp as apsp_mod
from . import hac as hac_mod
from .config import PipelineConfig, check_no_conflict
from .tmfg import tmfg_adjacency


@dataclass
class DBHTResult:
    """DBHT outputs, tensors on the device the stage ran on (the
    reference's fields; ``labels`` cuts on the host).  The integer fields
    are int32 from the device walk and int64 from the host walks, as in
    the reference."""

    linkage: torch.Tensor        # (n-1, 4) f32 scipy-style dendrogram
    cluster_of: torch.Tensor     # (n,) coarse cluster id per vertex
    bubble_of: torch.Tensor      # (n,) fine bubble per vertex
    converging: torch.Tensor     # int64 ids of converging bubbles
    direction: torch.Tensor      # (n-4,): +1 edge points parent->child
    apsp: torch.Tensor           # (n, n) f32 distances, or the hub
    #                              factor D_h (h, n) of the sparse tail
    hubs: Optional[torch.Tensor] = None  # (h,) i32 hub ids (sparse tail)

    def labels(self, k: int) -> np.ndarray:
        n = self.cluster_of.shape[0]
        return hac_mod.cut_linkage(self.linkage, n, k)


def _no_stage(name: str) -> None:
    pass


# ---------------------------------------------------------------------------
# the host oracle (impl="host"): numpy copies of the reference's walk
# ---------------------------------------------------------------------------

def euler_tour(parent: np.ndarray):
    """Preorder (tin, tout) of the bubble tree with children in ascending
    id, tout = tin + subtree size: the reference's DFS ``_euler_tour`` as
    two O(B) loops.  Parents have smaller ids than their children
    (insertion order)."""
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


def _edge_directions(S: np.ndarray, edges: np.ndarray,
                     bubble_parent: np.ndarray, bubble_tri: np.ndarray,
                     home_bubble: np.ndarray):
    """Direction of every bubble-tree edge by side connection strength,
    summed in float64 vertex by vertex (the reference's loops).

    Edge b (b >= 1) joins bubble b to its parent over the separating
    triangle t; a side's strength is the sum of the TMFG similarities
    from t's corners into the vertices whose home bubble lies on that
    side.  +1 when the edge points parent -> child (the subtree side is
    at least as strong), else -1.  Returns (direction, tin, tout)."""
    n = S.shape[0]
    B = bubble_parent.shape[0]
    tin, tout = euler_tour(bubble_parent)
    adj = [[] for _ in range(n)]
    for a, b in edges:
        adj[int(a)].append(int(b))
        adj[int(b)].append(int(a))
    home_tin = tin[home_bubble]
    direction = np.zeros(B, np.int64)
    for b in range(1, B):
        t = bubble_tri[b]
        tset = set(int(x) for x in t)
        lo, hi = tin[b], tout[b]
        s_child = 0.0
        s_parent = 0.0
        for v in t:
            for u in adj[int(v)]:
                if u in tset:
                    continue
                if lo <= home_tin[u] < hi:
                    s_child += S[int(v), u]
                else:
                    s_parent += S[int(v), u]
        direction[b] = 1 if s_child >= s_parent else -1
    return direction, tin, tout


def _flow_to_converging(bubble_parent: np.ndarray, direction: np.ndarray):
    """Follow each bubble's first outgoing edge until a converging bubble
    (one with no outgoing edge).  ``direction[b] = +1`` points the edge
    parent -> b.  Returns (destination per bubble, converging ids)."""
    B = bubble_parent.shape[0]
    out_edges = [[] for _ in range(B)]
    for b in range(1, B):
        p = bubble_parent[b]
        if direction[b] == 1:
            out_edges[p].append(b)
        else:
            out_edges[b].append(p)
    converging = np.array([b for b in range(B) if not out_edges[b]],
                          dtype=np.int64)
    dest = np.full(B, -1, np.int64)

    def walk(b):
        path = []
        cur = b
        while dest[cur] == -1 and out_edges[cur]:
            path.append(cur)
            cur = out_edges[cur][0]      # a tree: no cycle along out-edges
        d = dest[cur] if dest[cur] != -1 else cur
        dest[cur] = d
        for x in path:
            dest[x] = d
        return d

    for b in range(B):
        if dest[b] == -1:
            walk(b)
    return dest, converging


def host_tmfg(tmfg) -> Dict[str, np.ndarray]:
    """The TMFG's tree arrays as host numpy arrays."""
    return {f: getattr(tmfg, f).cpu().numpy()
            for f in ("edges", "bubble_parent", "bubble_tri",
                      "bubble_verts", "home_bubble")}


def _dbht_host(S, tmfg, *, apsp_method: str, apsp_backend: str,
               precomputed_apsp=None, apsp_hubs: int = 0,
               apsp_rounds: int = 0, done=_no_stage,
               stats: Optional[dict] = None) -> DBHTResult:
    """The reference's per-matrix numpy walk (the parity oracle).

    Directions, flow, clusters and the fine assignment run in numpy on
    the host, S in float64; APSP (unless ``precomputed_apsp``) and the
    one offset-adjusted complete linkage run on the device of the TMFG's
    tensors.  Holds S in float64 and an (n, B, 4) float32 array: an
    oracle for small n, not a production path."""
    dev = tmfg.edges.device
    S64 = (S.double().cpu().numpy() if isinstance(S, torch.Tensor)
           else np.asarray(S, np.float64))
    n = S64.shape[0]
    tm = host_tmfg(tmfg)
    bubble_parent, bubble_verts = tm["bubble_parent"], tm["bubble_verts"]
    home_bubble = tm["home_bubble"]
    B = bubble_parent.shape[0]

    direction, _, _ = _edge_directions(S64, tm["edges"], bubble_parent,
                                       tm["bubble_tri"], home_bubble)
    dest, converging = _flow_to_converging(bubble_parent, direction)
    conv_index = {int(c): i for i, c in enumerate(converging)}
    cluster_of = np.array([conv_index[int(dest[home_bubble[v]])]
                           for v in range(n)], dtype=np.int64)

    if precomputed_apsp is not None:
        D = _as_f32(precomputed_apsp, dev)
    else:
        W = apsp_mod.edge_lengths(n, tmfg.edges,
                                  torch.from_numpy(S64.astype(np.float32))
                                  .to(dev))
        D = apsp_mod.apsp(W, method=apsp_method, n_hubs=apsp_hubs,
                          rounds=apsp_rounds, backend=apsp_backend,
                          stats=stats)
        del W
    done("apsp")
    D_np = D.cpu().numpy()

    # fine assignment: the nearest (mean APSP) bubble of the cluster's
    # basin, the basin of c being the bubbles that flow to c
    bubble_cluster = np.array([conv_index[int(dest[b])] for b in range(B)],
                              dtype=np.int64)
    mean_dist = D_np[:, bubble_verts.reshape(-1)].reshape(n, B, 4).mean(
        axis=2)
    same = bubble_cluster[None, :] == cluster_of[:, None]          # (n, B)
    bubble_of = np.argmin(np.where(same, mean_dist, np.inf), axis=1)
    del mean_dist, same
    done("dbht")

    adj = hac_mod.hierarchical_offsets(
        D, torch.from_numpy(bubble_of).to(dev),
        torch.from_numpy(cluster_of).to(dev))
    Z = hac_mod.complete_linkage(adj, backend=apsp_backend)
    del adj
    done("hac")
    return DBHTResult(
        linkage=Z, cluster_of=torch.from_numpy(cluster_of).to(dev),
        bubble_of=torch.from_numpy(bubble_of).to(dev),
        converging=torch.from_numpy(converging).to(dev),
        direction=torch.from_numpy(direction[1:]).to(dev), apsp=D)


# ---------------------------------------------------------------------------
# the device form (impl="device")
# ---------------------------------------------------------------------------

def _steps(B: int) -> int:
    return int(math.ceil(math.log2(max(B, 2)))) + 1


def _anc_matrix(bubble_parent: torch.Tensor) -> torch.Tensor:
    """Ancestor-or-self indicator (B, B) bool of the bubble tree by
    pointer doubling (DESIGN.md §11.1): ``anc[b, a]`` iff a is on the
    path b -> root."""
    B = bubble_parent.shape[0]
    dev = bubble_parent.device
    ar = torch.arange(B, device=dev)
    ptr = torch.where(bubble_parent < 0, ar, bubble_parent.long())
    anc = torch.eye(B, dtype=torch.bool, device=dev)
    for _ in range(_steps(B)):
        anc |= anc.index_select(0, ptr)     # in place: one (B, B) buffer
        ptr = ptr.index_select(0, ptr)
    return anc


def _device_directions(S: torch.Tensor, edges: torch.Tensor,
                       bubble_tri: torch.Tensor, home_bubble: torch.Tensor,
                       anc: torch.Tensor) -> torch.Tensor:
    """Edge directions (B,) i32 for all tree edges in one (B, n)
    reduction (DESIGN.md §11.1); entry 0 (the root) is 0."""
    n = S.shape[0]
    A_w = tmfg_adjacency(n, edges, S)                  # (n, n), 0 off-graph
    tri = bubble_tri.long()                            # row 0 is (-1,-1,-1)
    t = tri % n                                        # the ref's wrap of -1
    # rows = (A_w[t0] + A_w[t1]) + A_w[t2], accumulated in place
    rows = A_w.index_select(0, t[:, 0])
    rows += A_w.index_select(0, t[:, 1])
    rows += A_w.index_select(0, t[:, 2])
    del A_w
    # zero each separating triangle's own columns (the ref's in_tri mask;
    # row 0 has no triangle and keeps its row, as there)
    rows[1:].scatter_(1, tri[1:], 0.0)
    member = anc.index_select(0, home_bubble.long()).T.contiguous()  # (B, n)
    s_child = rows.masked_fill(~member, 0.0).sum(dim=1)
    s_parent = rows.masked_fill_(member, 0.0).sum(dim=1)   # in place: last use
    direction = torch.where(s_child >= s_parent, 1, -1).to(torch.int32)
    direction[0] = 0
    return direction


def _device_flow(bubble_parent: torch.Tensor, direction: torch.Tensor):
    """Flow-to-converging by pointer jumping (DESIGN.md §11.2).

    Each bubble's successor is its parent when its own edge points up,
    else its lowest-id child whose edge points down, else itself
    (converging).  Returns (nxt, dest, conv_mask)."""
    B = bubble_parent.shape[0]
    dev = bubble_parent.device
    ar = torch.arange(B, device=dev)
    parent = bubble_parent.long()
    safe_parent = torch.where(ar >= 1, parent, 0)
    child_key = torch.where((ar >= 1) & (direction == 1), ar, B)
    first_child = torch.full((B,), B, dtype=torch.int64, device=dev)
    first_child.scatter_reduce_(0, safe_parent, child_key, "amin")
    to_parent = (ar >= 1) & (direction == -1)
    nxt = torch.where(to_parent, safe_parent,
                      torch.where(first_child < B, first_child, ar))
    dest = nxt
    for _ in range(_steps(B)):
        dest = dest.index_select(0, dest)
    return nxt, dest, nxt == ar


def _device_assign(D: torch.Tensor, bubble_verts: torch.Tensor,
                   home_bubble: torch.Tensor, dest: torch.Tensor,
                   conv_mask: torch.Tensor):
    """Coarse clusters and the fine bubble re-assignment: per vertex, the
    basin bubble with minimal mean APSP distance to its 4 vertices, one
    masked (n, B) argmin (DESIGN.md §11.1)."""
    conv_id = torch.cumsum(conv_mask.to(torch.int32), 0, dtype=torch.int32) - 1
    bubble_cluster = conv_id.index_select(0, dest)             # (B,)
    cluster_of = bubble_cluster.index_select(0, home_bubble.long())
    bv = bubble_verts.long()
    # ((D[:, b0] + D[:, b1]) + D[:, b2]) + D[:, b3], the ref's association,
    # accumulated in place into one (n, B) buffer
    md = D.index_select(1, bv[:, 0])
    for c in (1, 2, 3):
        md += D.index_select(1, bv[:, c])
    md /= 4.0
    same = bubble_cluster[None, :] == cluster_of[:, None]
    bubble_of = md.masked_fill_(~same, float("inf")).argmin(dim=1)
    return cluster_of, bubble_of.to(torch.int32), bubble_cluster


def _dbht_tree(S, edges, bubble_parent, bubble_tri, bubble_verts,
               home_bubble, D) -> Dict[str, torch.Tensor]:
    """Directions, flow, assignment and the offset-adjusted HAC input."""
    anc = _anc_matrix(bubble_parent)
    direction = _device_directions(S, edges, bubble_tri, home_bubble, anc)
    del anc
    _, dest, conv_mask = _device_flow(bubble_parent, direction)
    cluster_of, bubble_of, _ = _device_assign(
        D, bubble_verts, home_bubble, dest, conv_mask)
    adj = hac_mod.hierarchical_offsets(D, bubble_of, cluster_of)
    return dict(direction=direction, conv_mask=conv_mask,
                cluster_of=cluster_of, bubble_of=bubble_of, adj=adj)


def _dbht_device_core(S, edges, bubble_parent, bubble_tri, bubble_verts,
                      home_bubble, D, *, backend: str = "auto"):
    """Single-matrix device DBHT: TMFG arrays + APSP -> outputs."""
    out = _dbht_tree(S, edges, bubble_parent, bubble_tri, bubble_verts,
                     home_bubble, D)
    out["Z"] = hac_mod.complete_linkage(out.pop("adj"), backend=backend)
    out["D"] = D
    return out


def dense_tail(S: torch.Tensor, tm, cfg: PipelineConfig, *,
               D: Optional[torch.Tensor] = None, done=_no_stage):
    """The dense tail on a TMFG ``tm`` of S: edge lengths and APSP (unless
    ``D`` is given), the device DBHT tree and one nested linkage.
    Returns (the device-core dict, Bellman-Ford rounds); ``done(stage)``
    is called after "apsp", "dbht" and "hac" (the staged run's fences)."""
    stats = {"bf_rounds": 0}
    if D is None:
        W = apsp_mod.edge_lengths(S.shape[0], tm.edges, S)
        D = apsp_mod.apsp(W, method=cfg.apsp_method, n_hubs=cfg.apsp_hubs,
                          rounds=cfg.apsp_rounds, backend=cfg.backend,
                          stats=stats)
        del W
    done("apsp")
    out = _dbht_tree(S, tm.edges, tm.bubble_parent, tm.bubble_tri,
                     tm.bubble_verts, tm.home_bubble, D)
    done("dbht")
    out["Z"] = hac_mod.complete_linkage(out.pop("adj"), backend=cfg.backend)
    out["D"] = D
    done("hac")
    return out, stats["bf_rounds"]


def _result_from_device(out) -> DBHTResult:
    """DBHTResult from the device-core output dict."""
    conv = torch.nonzero(out["conv_mask"]).reshape(-1)
    return DBHTResult(
        linkage=out["Z"], cluster_of=out["cluster_of"],
        bubble_of=out["bubble_of"], converging=conv,
        direction=out["direction"][1:], apsp=out["D"])


def _as_f32(a, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dev, torch.float32)
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev)


def _tail_config(config: Optional[PipelineConfig], *, apsp_method=None,
                 backend=None, apsp_hubs=None,
                 apsp_rounds=None) -> PipelineConfig:
    """The APSP knobs and the backend from ``config`` or from the loose
    kwargs (combining the two is rejected); a loose kwarg left None takes
    the dataclass default."""
    check_no_conflict(config, apsp_method=apsp_method, backend=backend,
                      apsp_hubs=apsp_hubs, apsp_rounds=apsp_rounds)
    if config is not None:
        return config
    d = PipelineConfig()
    return d.replace(
        apsp_method=apsp_method or d.apsp_method,
        apsp_hubs=d.apsp_hubs if apsp_hubs is None else apsp_hubs,
        apsp_rounds=d.apsp_rounds if apsp_rounds is None else apsp_rounds,
        backend=backend or d.backend)


def run_dbht(S, tmfg, cfg: PipelineConfig, *, impl: str,
             edge_weights=None, precomputed_apsp=None, done=_no_stage,
             stats: Optional[dict] = None) -> DBHTResult:
    """The DBHT stage of ``cfg`` on a TMFG (tensors on the run's device):
    the sparse edge-list tail for ``apsp_method="sparse"`` (S may then be
    None when ``edge_weights`` holds the similarity of each TMFG edge),
    else the dense tail on S, on the device or as the host oracle.
    ``done(stage)`` is called after "apsp", "dbht" and "hac";
    ``stats``, if a dict, receives ``bf_rounds`` where a Bellman-Ford
    loop ran."""
    if impl not in ("device", "host"):
        raise ValueError(f"unknown DBHT impl {impl!r}")
    if cfg.apsp_method == "sparse" and precomputed_apsp is None:
        from . import sparse_dbht
        return sparse_dbht.dbht_sparse(
            S, tmfg, edge_weights=edge_weights, n_hubs=cfg.apsp_hubs,
            rounds=cfg.apsp_rounds, backend=cfg.backend, impl=impl,
            done=done, stats=stats)
    dev = tmfg.edges.device
    if impl == "host":
        return _dbht_host(S, tmfg, apsp_method=cfg.apsp_method,
                          apsp_backend=cfg.backend,
                          precomputed_apsp=precomputed_apsp,
                          apsp_hubs=cfg.apsp_hubs,
                          apsp_rounds=cfg.apsp_rounds, done=done,
                          stats=stats)
    D = None if precomputed_apsp is None else _as_f32(precomputed_apsp, dev)
    out, rounds = dense_tail(_as_f32(S, dev), tmfg, cfg, D=D, done=done)
    if stats is not None:
        stats["bf_rounds"] = rounds
    return _result_from_device(out)


def dbht(S, tmfg, *, apsp_method: Optional[str] = None,
         apsp_backend: Optional[str] = None,
         apsp_hubs: Optional[int] = None, apsp_rounds: Optional[int] = None,
         precomputed_apsp=None, config: Optional[PipelineConfig] = None,
         impl: Optional[str] = None, edge_weights=None) -> DBHTResult:
    """Run DBHT on a TMFG (a ``tmfg.TMFGResult`` of tensors on the run's
    device); S is a tensor or an array.

    ``config`` supplies the APSP knobs, the backend and the impl instead
    of the loose kwargs (combining the two is rejected, except ``impl``,
    the one deliberate override).  ``apsp_method="sparse"`` runs the
    edge-list tail (``sparse_dbht.dbht_sparse``), where S may be None
    when ``edge_weights`` gives the similarity of each TMFG edge;
    ``impl="host"`` runs the numpy oracle.
    """
    cfg = _tail_config(config, apsp_method=apsp_method, backend=apsp_backend,
                       apsp_hubs=apsp_hubs, apsp_rounds=apsp_rounds)
    return run_dbht(S, tmfg, cfg, impl=impl or cfg.dbht_impl,
                    edge_weights=edge_weights,
                    precomputed_apsp=precomputed_apsp)


def tmfg_entry(tmfg, b: int):
    """Entry b of a batched TMFG (every field with a leading batch axis)."""
    return type(tmfg)(*(f[b] for f in tmfg))


def dbht_batch(S, tmfg, *, apsp_method: Optional[str] = None,
               backend: Optional[str] = None,
               apsp_hubs: Optional[int] = None,
               apsp_rounds: Optional[int] = None,
               config: Optional[PipelineConfig] = None,
               limit: Optional[int] = None,
               edge_weights=None) -> List[DBHTResult]:
    """Device DBHT for a batch: S (B, n, n) and a batched TMFG (every
    field with a leading B axis, tensors on the run's device).

    The entries run one after another on the device; the linkages of the
    first ``limit`` entries (all by default) then come to the host in one
    copy, and each result's ``linkage`` is its row of it (the other
    fields stay on the device).  Entries past ``limit`` do device work
    only.  The sparse method runs :func:`sparse_dbht.dbht_sparse` per
    entry, for the first ``limit`` entries only, as in the reference (S
    may be None there when ``edge_weights`` (B, 3n-6) is given).
    ``config`` supplies the APSP knobs and the backend instead of the
    loose kwargs (combining the two is rejected).
    """
    cfg = _tail_config(config, apsp_method=apsp_method, backend=backend,
                       apsp_hubs=apsp_hubs, apsp_rounds=apsp_rounds)
    B = len(S) if S is not None else len(edge_weights)
    B_out = B if limit is None else min(limit, B)
    sparse = cfg.apsp_method == "sparse"
    res = []
    for b in range(B_out if sparse else B):
        res.append(run_dbht(
            None if S is None else S[b], tmfg_entry(tmfg, b), cfg,
            impl="device",
            edge_weights=None if edge_weights is None else edge_weights[b]))
    res = res[:B_out]
    Z = torch.stack([r.linkage for r in res]).cpu()     # the one copy
    for r, z in zip(res, Z):
        r.linkage = z
    return res
