"""Pure-numpy reference oracles for TMFG construction.

The port's copy of ``repro.core.tmfg_ref`` (numpy only; the port imports
nothing of the JAX package).  These are the ground-truth implementations
the device builders of ``core/tmfg.py`` are tested against.  Four
constructions are provided, mirroring the paper:

  * ``tmfg_exact``   — Massara et al.'s serial algorithm: at every step the
    globally best (face, vertex) pair by true gain is inserted (this is
    PAR-TMFG with prefix size 1 in the paper's nomenclature).
  * ``tmfg_orig``    — Yu & Shun's ORIG-TMFG with prefix size P: each round
    computes the best vertex per face, deduplicates by vertex, and inserts up
    to P pairs at once.
  * ``tmfg_corr``    — the paper's CORR-TMFG (Algorithm 1) with prefix 1 and
    eager updates: candidates for a face are the max-correlation vertices of
    the face's three corners.
  * ``tmfg_lazy``    — the paper's HEAP-TMFG (Algorithm 2): lazy re-validation
    of popped face-vertex pairs via an actual binary heap.

All of them return a :class:`TMFGResult`, which carries the edge list, the
face list, the insertion log and the bubble tree, so downstream DBHT oracles
can run directly on it.

Ties are broken toward the lowest vertex / face index everywhere (matching
``np.argmax`` / ``torch.argmax`` semantics) so the device builders can be
compared exactly on untied inputs and statistically on tied ones.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

NEG = -np.inf


@dataclass
class TMFGResult:
    n: int
    clique: np.ndarray                 # (4,)  initial clique
    edges: np.ndarray                  # (3n-6, 2)
    faces: np.ndarray                  # (2n-4, 3) final triangular faces
    insert_order: np.ndarray           # (n,)  vertices in insertion order
    # bubble tree: bubble 0 is the initial 4-clique; bubble i>0 is created by
    # the i-th vertex insertion.
    bubble_verts: np.ndarray           # (n-3, 4)
    bubble_parent: np.ndarray          # (n-3,)  parent bubble id (-1 for root)
    bubble_tri: np.ndarray             # (n-3, 3) separating triangle vs parent
    home_bubble: np.ndarray = field(default=None)  # (n,) bubble created by v

    @property
    def edge_sum(self) -> float:
        return float(self._edge_sum)

    def set_edge_sum(self, s: float) -> None:
        self._edge_sum = s

    def adjacency(self, S: np.ndarray) -> np.ndarray:
        """Dense weighted adjacency of the TMFG (0 where no edge)."""
        A = np.zeros_like(S)
        e = self.edges
        A[e[:, 0], e[:, 1]] = S[e[:, 0], e[:, 1]]
        A[e[:, 1], e[:, 0]] = S[e[:, 1], e[:, 0]]
        return A


class _Builder:
    """Shared incremental TMFG state used by all reference constructions."""

    def __init__(self, S: np.ndarray):
        S = np.asarray(S, dtype=np.float64)
        n = S.shape[0]
        assert S.shape == (n, n) and n >= 4, "S must be square with n>=4"
        self.S = S.copy()
        np.fill_diagonal(self.S, NEG)
        self.n = n
        self.inserted = np.zeros(n, dtype=bool)
        self.edges: List[Tuple[int, int]] = []
        # faces stored in a flat list; "replaced" faces are overwritten in
        # place so that indices remain stable (mirrors the JAX layout).
        self.faces: List[Tuple[int, int, int]] = []
        self.face_bubble: List[int] = []
        self.insert_order: List[int] = []
        self.bubble_verts: List[Tuple[int, int, int, int]] = []
        self.bubble_parent: List[int] = []
        self.bubble_tri: List[Tuple[int, int, int]] = []
        self.home_bubble = np.zeros(n, dtype=np.int64)
        self.edge_sum = 0.0
        self._init_clique()

    # -- initialization ----------------------------------------------------
    def _init_clique(self) -> None:
        S = self.S
        row_sums = np.where(np.isfinite(S), S, 0.0).sum(axis=1)
        # four vertices with largest row sums; ties toward lower index
        order = np.argsort(-row_sums, kind="stable")
        c = np.sort(order[:4])
        self.clique = c
        v1, v2, v3, v4 = (int(x) for x in c)
        for a, b in ((v1, v2), (v1, v3), (v1, v4), (v2, v3), (v2, v4), (v3, v4)):
            self._add_edge(a, b)
        for tri in ((v1, v2, v3), (v1, v2, v4), (v1, v3, v4), (v2, v3, v4)):
            self.faces.append(tri)
            self.face_bubble.append(0)
        self.bubble_verts.append((v1, v2, v3, v4))
        self.bubble_parent.append(-1)
        self.bubble_tri.append((-1, -1, -1))
        for v in c:
            self.inserted[int(v)] = True
            self.insert_order.append(int(v))
            self.home_bubble[int(v)] = 0

    def _add_edge(self, a: int, b: int) -> None:
        self.edges.append((min(a, b), max(a, b)))
        self.edge_sum += self.S[a, b]

    # -- queries -----------------------------------------------------------
    def gain(self, face: Tuple[int, int, int], v: int) -> float:
        a, b, c = face
        return self.S[a, v] + self.S[b, v] + self.S[c, v]

    def max_corr(self, v: int) -> int:
        """Best *uninserted* vertex by similarity to v (lowest index ties)."""
        row = np.where(self.inserted, NEG, self.S[v])
        return int(np.argmax(row))

    def best_vertex_exact(self, face: Tuple[int, int, int]) -> Tuple[int, float]:
        a, b, c = face
        g = self.S[a] + self.S[b] + self.S[c]
        g = np.where(self.inserted, NEG, g)
        u = int(np.argmax(g))
        return u, float(g[u])

    def best_vertex_corr(self, face: Tuple[int, int, int]) -> Tuple[int, float]:
        cands = [self.max_corr(w) for w in face]
        gains = [self.gain(face, u) for u in cands]
        j = int(np.argmax(gains))
        return cands[j], float(gains[j])

    # -- mutation ----------------------------------------------------------
    def insert(self, face_idx: int, v: int) -> int:
        """Insert v into faces[face_idx]; returns the new bubble id."""
        t = self.faces[face_idx]
        a, b, c = t
        assert not self.inserted[v]
        self.inserted[v] = True
        self.insert_order.append(int(v))
        for w in t:
            self._add_edge(int(w), int(v))
        bub = len(self.bubble_verts)
        self.bubble_verts.append((int(v), a, b, c))
        self.bubble_parent.append(self.face_bubble[face_idx])
        self.bubble_tri.append(t)
        self.home_bubble[v] = bub
        # replace t in place with (v,a,b); append (v,b,c), (v,a,c)
        self.faces[face_idx] = (int(v), a, b)
        self.face_bubble[face_idx] = bub
        self.faces.append((int(v), b, c))
        self.face_bubble.append(bub)
        self.faces.append((int(v), a, c))
        self.face_bubble.append(bub)
        return bub

    def result(self) -> TMFGResult:
        n = self.n
        res = TMFGResult(
            n=n,
            clique=np.asarray(self.clique, dtype=np.int64),
            edges=np.asarray(self.edges, dtype=np.int64),
            faces=np.asarray(self.faces, dtype=np.int64),
            insert_order=np.asarray(self.insert_order, dtype=np.int64),
            bubble_verts=np.asarray(self.bubble_verts, dtype=np.int64),
            bubble_parent=np.asarray(self.bubble_parent, dtype=np.int64),
            bubble_tri=np.asarray(self.bubble_tri, dtype=np.int64),
            home_bubble=self.home_bubble,
        )
        res.set_edge_sum(self.edge_sum)
        assert len(self.edges) == 3 * n - 6
        assert len(self.faces) == 2 * n - 4
        assert len(self.bubble_verts) == n - 3
        return res


# ---------------------------------------------------------------------------
# constructions
# ---------------------------------------------------------------------------

def tmfg_exact(S: np.ndarray) -> TMFGResult:
    """Serial TMFG: globally best (face, vertex) by true gain each step."""
    B = _Builder(S)
    while len(B.insert_order) < B.n:
        best = (NEG, -1, -1)
        for fi, face in enumerate(B.faces):
            u, g = B.best_vertex_exact(face)
            if g > best[0]:
                best = (g, fi, u)
        _, fi, u = best
        B.insert(fi, u)
    return B.result()


def tmfg_orig(S: np.ndarray, prefix: int = 10) -> TMFGResult:
    """Yu & Shun's ORIG-TMFG with prefix size P (the paper's baseline)."""
    B = _Builder(S)
    while len(B.insert_order) < B.n:
        pairs = []  # (gain, face_idx, vertex)
        for fi, face in enumerate(B.faces):
            u, g = B.best_vertex_exact(face)
            pairs.append((g, fi, u))
        # dedupe by vertex keeping max gain (stable toward earlier face)
        pairs.sort(key=lambda t: (-t[0], t[1]))
        chosen, used_v = [], set()
        for g, fi, u in pairs:
            if u in used_v:
                continue
            used_v.add(u)
            chosen.append((fi, u))
            if len(chosen) == prefix:
                break
        for fi, u in chosen:
            if len(B.insert_order) < B.n:
                B.insert(fi, u)
    return B.result()


def tmfg_corr(S: np.ndarray) -> TMFGResult:
    """CORR-TMFG (Algorithm 1), prefix 1, eager updates."""
    B = _Builder(S)
    # cached (gain, vertex) per face index, eagerly maintained
    cache = {fi: B.best_vertex_corr(f) for fi, f in enumerate(B.faces)}
    while len(B.insert_order) < B.n:
        fi = max(cache, key=lambda i: (cache[i][1], -i))
        v, _ = cache[fi]
        n_faces_before = len(B.faces)
        B.insert(fi, v)
        # eager update: new faces + all faces whose cached vertex was v
        stale = [i for i, (u, _) in cache.items() if u == v]
        for i in stale:
            cache[i] = B.best_vertex_corr(B.faces[i])
        for i in (fi, n_faces_before, n_faces_before + 1):
            if len(B.insert_order) < B.n:
                cache[i] = B.best_vertex_corr(B.faces[i])
            else:
                cache[i] = (-1, NEG)
    return B.result()


def tmfg_lazy(S: np.ndarray) -> TMFGResult:
    """HEAP-TMFG (Algorithm 2): lazy re-validation through a max-heap."""
    B = _Builder(S)
    # faces are replaced in-place on insert, so a popped (fi, v) may refer to
    # an old triangle; we guard with a version counter per face slot.
    heap = []  # (-gain, face_idx, face_version, vertex)
    version = {fi: 0 for fi in range(len(B.faces))}

    def push2(fi):
        v, g = B.best_vertex_corr(B.faces[fi])
        heapq.heappush(heap, (-g, fi, version[fi], v))

    for fi in range(len(B.faces)):
        push2(fi)

    while len(B.insert_order) < B.n:
        ng, fi, ver, v = heapq.heappop(heap)
        if version[fi] != ver:
            continue  # face slot was replaced; its successor faces were pushed
        if B.inserted[v]:
            push2(fi)  # lazy re-validation
            continue
        n_faces_before = len(B.faces)
        B.insert(fi, v)
        version[fi] += 1
        for i in (fi, n_faces_before, n_faces_before + 1):
            version.setdefault(i, 0)
            if len(B.insert_order) < B.n:
                push2(i)
    return B.result()


# ---------------------------------------------------------------------------
# reference shortest paths / linkage (oracles for apsp.py and hac.py)
# ---------------------------------------------------------------------------

def dijkstra_apsp(dist_adj: np.ndarray) -> np.ndarray:
    """Exact APSP via per-source Dijkstra on a dense nonneg adjacency.

    ``dist_adj[i, j]`` is the edge length (np.inf where no edge, 0 diag).
    """
    n = dist_adj.shape[0]
    out = np.full((n, n), np.inf)
    adj = [[] for _ in range(n)]
    ii, jj = np.nonzero(np.isfinite(dist_adj) & (dist_adj > 0))
    for i, j in zip(ii, jj):
        adj[i].append((j, dist_adj[i, j]))
    for s in range(n):
        d = out[s]
        d[s] = 0.0
        pq = [(0.0, s)]
        while pq:
            du, u = heapq.heappop(pq)
            if du > d[u]:
                continue
            for v, w in adj[u]:
                nd = du + w
                if nd < d[v]:
                    d[v] = nd
                    heapq.heappush(pq, (nd, v))
    return out


def complete_linkage(D: np.ndarray) -> np.ndarray:
    """Naive O(n^3) complete-linkage HAC; returns scipy-style linkage matrix.

    Rows: (left_id, right_id, height, size) with cluster ids < n for leaves
    and n+k for the cluster made at merge k.
    """
    n = D.shape[0]
    D = D.astype(np.float64).copy()
    np.fill_diagonal(D, np.inf)
    active = list(range(n))
    ids = list(range(n))
    sizes = {i: 1 for i in range(n)}
    Z = np.zeros((n - 1, 4))
    cur = D
    for k in range(n - 1):
        m = len(active)
        sub = cur[np.ix_(active, active)]
        flat = np.argmin(sub)
        i, j = divmod(int(flat), m)
        if i > j:
            i, j = j, i
        ai, aj = active[i], active[j]
        h = sub[i, j]
        new_id = n + k
        Z[k] = (ids[i], ids[j], h, sizes[ids[i]] + sizes[ids[j]])
        sizes[new_id] = sizes[ids[i]] + sizes[ids[j]]
        # complete linkage: new row is elementwise max
        row = np.maximum(cur[ai], cur[aj])
        cur[ai] = row
        cur[:, ai] = row
        cur[ai, ai] = np.inf
        ids[i] = new_id
        del active[j]
        del ids[j]
    return Z


def cut_linkage(Z: np.ndarray, n: int, k: int) -> np.ndarray:
    """Cut a linkage matrix into k flat clusters (labels in [0, k))."""
    k = max(1, min(k, n))
    parent = np.arange(n + len(Z))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    # apply merges in height order until only k clusters remain
    order = np.argsort(Z[:, 2], kind="stable")
    clusters = n
    for idx in order:
        if clusters <= k:
            break
        a, b = int(Z[idx, 0]), int(Z[idx, 1])
        new = n + int(idx)
        parent[find(a)] = new
        parent[find(b)] = new
        clusters -= 1
    roots = {}
    labels = np.zeros(n, dtype=np.int64)
    for v in range(n):
        r = find(v)
        labels[v] = roots.setdefault(r, len(roots))
    return labels
