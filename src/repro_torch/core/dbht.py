"""DBHT — Directed Bubble Hierarchy Tree clustering on a TMFG, on device.

The port of the device half of ``repro.core.dbht`` (DESIGN.md §11): the
bubble-tree ancestry by pointer doubling, the edge directions as one
(B, n) reduction, the converging-bubble flow by pointer jumping, the fine
assignment as one masked (n, B) argmin, and the nested complete linkage
on the offset-adjusted APSP matrix (``hac.hierarchical_offsets``).  Every
step is a fixed-shape tensor program, as in the reference; nothing goes
to the host until the result is unpacked.

The host oracle (``impl="host"``) and ``dbht_batch`` are ROADMAP Queue 1
item 5.  The (n, n)-sized steps update in place where that saves a
second (n, n) buffer; each such place says so.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from . import apsp as apsp_mod
from . import hac as hac_mod
from .config import PipelineConfig, not_ported
from .tmfg import tmfg_adjacency


@dataclass
class DBHTResult:
    """DBHT outputs, tensors on the device the stage ran on (the
    reference's fields; ``labels`` cuts on the host)."""

    linkage: torch.Tensor        # (n-1, 4) f32 scipy-style dendrogram
    cluster_of: torch.Tensor     # (n,) i32 coarse cluster id per vertex
    bubble_of: torch.Tensor      # (n,) i32 fine bubble per vertex
    converging: torch.Tensor     # int64 ids of converging bubbles
    direction: torch.Tensor      # (n-4,) i32: +1 edge points parent->child
    apsp: torch.Tensor           # (n, n) f32 distances, or the hub
    #                              factor D_h (h, n) of the sparse tail
    hubs: Optional[torch.Tensor] = None  # (h,) i32 hub ids (sparse tail)

    def labels(self, k: int) -> np.ndarray:
        n = self.cluster_of.shape[0]
        return hac_mod.cut_linkage(self.linkage, n, k)


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


def _no_stage(name: str) -> None:
    pass


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


def dbht(S: torch.Tensor, tmfg, *, apsp_method: Optional[str] = None,
         apsp_backend: Optional[str] = None,
         apsp_hubs: Optional[int] = None, apsp_rounds: Optional[int] = None,
         precomputed_apsp: Optional[torch.Tensor] = None,
         config: Optional[PipelineConfig] = None,
         impl: Optional[str] = None) -> DBHTResult:
    """Run DBHT on a TMFG (a ``tmfg.TMFGResult`` of tensors on S's device).

    ``config`` supplies the APSP knobs and the backend instead of the
    loose kwargs (combining the two is rejected); ``impl="host"`` and
    ``apsp_method="sparse"`` raise NotImplementedError.
    """
    loose = dict(apsp_method=apsp_method, apsp_backend=apsp_backend,
                 apsp_hubs=apsp_hubs, apsp_rounds=apsp_rounds)
    if config is not None:
        clash = sorted(k for k, v in loose.items() if v is not None)
        if clash:
            raise ValueError(f"config= conflicts with {clash}: pass one "
                             f"surface, or use config.replace(...)")
        cfg = config
    else:
        d = PipelineConfig()
        cfg = d.replace(
            apsp_method=apsp_method or d.apsp_method,
            apsp_hubs=d.apsp_hubs if apsp_hubs is None else apsp_hubs,
            apsp_rounds=d.apsp_rounds if apsp_rounds is None else apsp_rounds,
            backend=apsp_backend or d.backend)
    impl = impl or cfg.dbht_impl
    if impl == "host":
        raise not_ported("dbht_impl", "host")
    if impl != "device":
        raise ValueError(f"unknown DBHT impl {impl!r}")
    S = S.float()
    D = None if precomputed_apsp is None else \
        precomputed_apsp.to(S.device, torch.float32)
    out, _ = dense_tail(S, tmfg, cfg, D=D)
    return _result_from_device(out)
