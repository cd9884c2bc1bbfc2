"""TMFG construction in PyTorch — the paper's HEAP-TMFG (lazy) method.

The port of ``repro.core.tmfg`` for ``method="lazy"`` with or without the
up-front top-K candidate table (the OPT and HEAP variants).  The CORR and
ORIG constructions are ROADMAP Queue 1 item 2.

The reference runs the lazy loop as one ``lax.while_loop`` on the device.
Its pop count depends on the data and every pop branches on a device
value (is the popped face's cached vertex stale?), so an eager PyTorch
loop has to bring something to the host on every pop.  The port splits
the state accordingly:

  * on the device: the values -- the (n, n) similarity S and the (n, K)
    candidate table here (``_Device``), or the table-first source of the
    sparse build (``repro_torch.approx.sparse_tmfg``), both driven by the
    one loop :func:`lazy_loop` -- and the ``inserted`` mask that the
    candidate lookups read;
  * on the host (numpy): the O(n) bookkeeping — faces, edges, bubbles,
    insertion order — and the per-face cached (gain, best vertex), so
    the vectorized heap-pop (argmax over the face gains) and the stale
    test run on the host without a transfer.

Each pop then makes exactly one device round trip: the popped face's
corner indices go up in one copy from a pinned buffer, the device runs
the candidate lookups and the face-gain gathers, and one copy brings back
the new (best vertex, gain) of the touched faces and, on an insert, the
three new edge weights (and the sparse source's fallback and miss
counts).  Building at n vertices costs ``pops + 2`` host syncs (two for
the initial clique), and no host-to-device copy waits for the stream;
:func:`_build_lazy` returns the count.  The clique's row sums reduce
(64, n) panels, so the dense and the sparse build sum every row with the
same operands and the same reduction on every device.

Maxcorr (a row's best uninserted vertex) is never cached on the host:
the reference only ever reads it for the corners of a face it has just
refreshed, so the port recomputes those corners' lookups in the same
round trip.  The arithmetic that decides the result is the reference's:
the 3-term face gains are summed in its order ((s0 + s1) + s2), the edge
sum adds one edge at a time in float32, ties break to the lowest index
(``torch.argmax`` returns the first maximum; the candidate table comes
from a stable descending sort, like ``lax.top_k``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import not_ported

NEG = float("-inf")

# rows per chunk of the stable sort that builds the candidate table,
# bounding its (rows, n) value and index buffers
_SORT_ELEMS = 1 << 26

# corner positions of the faces a step touches, as positions in the list
# of looked-up vertices: the 4 faces of the initial clique (v1..v4), the
# 3 faces an insert of v into (a, b, c) creates — (v,a,b), (v,b,c),
# (v,a,c) — and the one face a stale pop refreshes
_CLIQUE_FACES = [[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]]
_INSERT_FACES = [[0, 1, 2], [0, 2, 3], [0, 1, 3]]
_STALE_FACES = [[0, 1, 2]]
# the 6 edges of the initial clique, as positions in the clique
_CLIQUE_EDGES = [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]]


class TMFGResult(NamedTuple):
    """Fixed-shape TMFG output, tensors on the similarity's device
    (the reference's field names and dtypes)."""

    clique: torch.Tensor         # (4,) i32
    edges: torch.Tensor          # (3n-6, 2) i32
    faces: torch.Tensor          # (2n-4, 3) i32
    insert_order: torch.Tensor   # (n,) i32
    bubble_verts: torch.Tensor   # (n-3, 4) i32
    bubble_parent: torch.Tensor  # (n-3,) i32
    bubble_tri: torch.Tensor     # (n-3, 3) i32
    home_bubble: torch.Tensor    # (n,) i32
    edge_sum: torch.Tensor       # () f32
    pops: torch.Tensor           # () i32 — total pop iterations


def candidate_table(S: torch.Tensor, k: int) -> torch.Tensor:
    """(n, k) int64: each row's k most similar columns, value descending,
    index ascending on ties (``lax.top_k``'s order), by a stable sort."""
    n = S.shape[0]
    chunk = max(1, _SORT_ELEMS // max(n, 1))
    parts = []
    for r0 in range(0, n, chunk):
        _, idx = torch.sort(S[r0:r0 + chunk], dim=1, descending=True,
                            stable=True)
        parts.append(idx[:, :k].clone())
    return torch.cat(parts)


# rows per panel of the clique's row sums; the sparse build reduces
# (ROW_SUM_PANEL, n) panels of its table, and the dense one panels of S of
# the same shape, so both sum every row in the same order on every device
ROW_SUM_PANEL = 64


def panel_row_sums(panel, n: int) -> torch.Tensor:
    """Finite row sums ``where(isfinite(P), P, 0).sum(1)`` of the (n, n)
    matrix whose rows ``panel(r0, r1)`` returns, ROW_SUM_PANEL rows at a
    time (the reference's ``_row_sums_blocked`` panels)."""
    parts = []
    for r0 in range(0, n, ROW_SUM_PANEL):
        P = panel(r0, min(r0 + ROW_SUM_PANEL, n))
        parts.append(torch.where(torch.isfinite(P), P, 0.0).sum(dim=1))
    return torch.cat(parts)


class _Source:
    """The device half of the lazy construction: the ``inserted`` mask the
    lookups read, the pinned index upload and the counted download.

    A value source (``_Device`` here, the table-first source in
    ``repro_torch.approx.sparse_tmfg``) adds:

      * ``row_sums()``    -- (n,) finite row sums for the clique choice;
      * ``seed_lookup(W)`` -- the clique corners' first best vertices;
      * ``lookup(W)``     -- (best uninserted vertex per row of W,
                             fallback count or None);
      * ``values(r, c)``  -- (S[r, c], miss count or None).

    The counts stay on the device and ride the step's one download.
    """

    def __init__(self, n: int, dev: torch.device):
        self.n = n
        self.device = dev
        self.inserted = torch.zeros(n, dtype=torch.bool, device=dev)
        pin = dev.type == "cuda"
        self._host = torch.empty(4, dtype=torch.int64, pin_memory=pin)
        self._dev = torch.empty(4, dtype=torch.int64, device=dev)
        self._faces = {len(p): self._const(p)
                       for p in (_CLIQUE_FACES, _INSERT_FACES, _STALE_FACES)}
        self.clique_edges = self._const(_CLIQUE_EDGES)
        self.syncs = 0

    def _const(self, rows) -> torch.Tensor:
        """A small index constant on the device; through pinned memory
        on a card, so the copy does not wait for the stream."""
        t = torch.tensor(rows, dtype=torch.int64)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def upload(self, verts) -> torch.Tensor:
        """The vertex list on the device, through the pinned buffer.

        Reusing the buffer is safe: every step ends in a device->host
        copy that waits for the stream, this upload included."""
        w = len(verts)
        self._host.numpy()[:w] = verts
        return self._dev[:w].copy_(self._host[:w], non_blocking=True)

    def download(self, t: torch.Tensor) -> np.ndarray:
        self.syncs += 1
        return t.cpu().numpy()

    def first_uninserted(self, table: torch.Tensor, W: torch.Tensor):
        """(first uninserted entry of each row of W in ``table`` (n, K),
        whether there is one); the table is sorted best first."""
        tk = table.index_select(0, W)                        # (w, K)
        ok = ~self.inserted[tk]
        j = ok.to(torch.int32).argmax(dim=1, keepdim=True)   # first True
        return tk.gather(1, j)[:, 0], ok.gather(1, j)[:, 0]

    def pairs(self, W: torch.Tensor, mc: torch.Tensor, nfaces: int):
        """(best vertex, gain, miss count or None) of the step's
        ``nfaces`` faces, given as corner positions in W, from the
        corners' fresh lookups ``mc``."""
        pos = self._faces[nfaces]
        fv = W[pos]                                          # (q, 3)
        cands = mc[pos]                                      # (q, 3)
        q = fv.shape[0]
        M, miss = self.values(fv[:, :, None].expand(q, 3, 3),
                              cands[:, None, :].expand(q, 3, 3))
        g = (M[:, 0] + M[:, 1]) + M[:, 2]                    # the ref's order
        j = g.argmax(dim=1, keepdim=True)
        return cands.gather(1, j)[:, 0], g.gather(1, j)[:, 0], miss


class _Device(_Source):
    """Dense values: S, and the optional candidate table of the lookups."""

    def __init__(self, S: torch.Tensor, table: Optional[torch.Tensor]):
        self.S = S
        self.table = table
        super().__init__(S.shape[0], S.device)

    def row_sums(self) -> torch.Tensor:
        return panel_row_sums(lambda r0, r1: self.S[r0:r1], self.n)

    def lookup_full(self, W: torch.Tensor) -> torch.Tensor:
        """Best uninserted column of each row in W: a masked row argmax."""
        rows = self.S.index_select(0, W)
        return rows.masked_fill_(self.inserted[None, :], NEG).argmax(dim=1)

    def seed_lookup(self, W: torch.Tensor) -> torch.Tensor:
        # the reference seeds maxcorr with full-row scans, not the table
        return self.lookup_full(W)

    def lookup(self, W: torch.Tensor):
        """Best uninserted vertex per row of W through the candidate table:
        the first uninserted entry, else the full-row scan.  Both are
        computed and selected with ``torch.where`` (one device program,
        no branch on a device value)."""
        full = self.lookup_full(W)
        if self.table is None:
            return full, None
        best, found = self.first_uninserted(self.table, W)
        return torch.where(found, best, full), None

    def values(self, r: torch.Tensor, c: torch.Tensor):
        return self.S[r, c], None


class SparseCounters(NamedTuple):
    """Lookup and pair-value counts of one lazy construction, the
    reference's ``SparseCounters`` as host ints (fallbacks and misses
    stay 0 for dense values)."""

    lookups: int
    fallbacks: int
    pair_lookups: int
    pair_misses: int


def _f32_sum(acc: np.float32, vals) -> np.float32:
    """Sequential float32 sum, one term at a time (the reference's order)."""
    for v in vals:
        acc = np.float32(acc + np.float32(v))
    return acc


def _counts(*ts):
    """The step's device counts that exist, as doubles for the download."""
    return [t.double().view(1) for t in ts if t is not None]


def lazy_loop(d: _Source):
    """The lazy construction over any value source ``d``.

    Returns (TMFGResult, host syncs, per-edge values (3n-6,) float32 in
    edge order, SparseCounters)."""
    n = d.n
    dev = d.device
    F, E, B = 2 * n - 4, 3 * n - 6, n - 3

    # -- initial clique: the 4 largest finite row sums -----------------------
    top4 = torch.sort(d.row_sums(), descending=True, stable=True)[1][:4]
    clique = [int(x) for x in np.sort(d.download(top4))]
    v1, v2, v3, v4 = clique

    inserted = np.zeros(n, bool)
    inserted[clique] = True
    insert_order = np.zeros(n, np.int32)
    insert_order[:4] = clique
    edges = np.zeros((E, 2), np.int32)
    init_edges = [(v1, v2), (v1, v3), (v1, v4), (v2, v3), (v2, v4), (v3, v4)]
    edges[:6] = init_edges
    w_edges = np.zeros(E, np.float32)
    faces = np.zeros((F, 3), np.int32)
    faces[:4] = [(v1, v2, v3), (v1, v2, v4), (v1, v3, v4), (v2, v3, v4)]
    face_bubble = np.zeros(F, np.int32)
    bubble_verts = np.zeros((B, 4), np.int32)
    bubble_verts[0] = clique
    bubble_parent = np.full(B, -1, np.int32)
    bubble_tri = np.full((B, 3), -1, np.int32)
    home_bubble = np.zeros(n, np.int32)
    gains = np.full(F, NEG, np.float32)
    best_v = np.zeros(F, np.int64)

    W = d.upload(clique)
    d.inserted.index_fill_(0, W, True)
    best, gain, miss = d.pairs(W, d.seed_lookup(W), 4)
    ei = W[d.clique_edges]                               # (6, 2) vertices
    ev, miss_e = d.values(ei[:, 0], ei[:, 1])
    got = d.download(torch.cat([best.double(), gain.double(), ev.double(),
                                *_counts(miss, miss_e)]))
    best_v[:4] = got[0:4]
    gains[:4] = got[4:8]
    w_edges[:6] = got[8:14]
    edge_sum = _f32_sum(np.float32(0.0), got[8:14])
    lookups, fallbacks, pair_lookups = 0, 0, 6 + 9 * 4
    misses = int(got[14:].sum())

    n_ins, n_faces, n_edges, pops = 4, 4, 6, 0
    while n_ins < n:
        f = int(np.argmax(gains))              # vectorized heap-pop
        v = int(best_v[f])
        a, b, c = (int(x) for x in faces[f])
        if inserted[v]:
            # stale: re-validate the face's corners (Alg. 2 else-branch)
            W = d.upload([a, b, c])
            mc, fb = d.lookup(W)
            best, gain, miss = d.pairs(W, mc, 1)
            got = d.download(torch.cat([best.double(), gain.double(),
                                        *_counts(fb, miss)]))
            best_v[f] = got[0]
            gains[f] = got[1]
            lookups += 3
            pair_lookups += 9
            extra = got[2:]
        else:
            W = d.upload([v, a, b, c])
            d.inserted.index_fill_(0, W[:1], True)
            # the 3 new faces' pairs from the 4 refreshed corners
            mc, fb = d.lookup(W)
            best, gain, miss = d.pairs(W, mc, 3)
            ev, miss_e = d.values(W[:1].expand(3), W[1:])
            got = d.download(torch.cat([best.double(), gain.double(),
                                        ev.double(),
                                        *_counts(fb, miss, miss_e)]))
            inserted[v] = True
            insert_order[n_ins] = v
            n_ins += 1
            edges[n_edges:n_edges + 3] = [(v, a), (v, b), (v, c)]
            w_edges[n_edges:n_edges + 3] = got[6:9]
            n_edges += 3
            edge_sum = _f32_sum(edge_sum, got[6:9])
            bub = n_ins - 4
            bubble_verts[bub] = (v, a, b, c)
            bubble_parent[bub] = face_bubble[f]
            bubble_tri[bub] = (a, b, c)
            home_bubble[v] = bub
            slots = (f, n_faces, n_faces + 1)
            faces[f] = (v, a, b)
            faces[n_faces] = (v, b, c)
            faces[n_faces + 1] = (v, a, c)
            face_bubble[list(slots)] = bub
            n_faces += 2
            best_v[list(slots)] = got[0:3]
            gains[list(slots)] = got[3:6]
            lookups += 4
            pair_lookups += 3 + 27
            extra = got[9:]
        if extra.size:
            fallbacks += int(extra[0])
            misses += int(extra[1:].sum())
        pops += 1

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    res = TMFGResult(
        clique=t(insert_order[:4]), edges=t(edges), faces=t(faces),
        insert_order=t(insert_order), bubble_verts=t(bubble_verts),
        bubble_parent=t(bubble_parent), bubble_tri=t(bubble_tri),
        home_bubble=t(home_bubble),
        edge_sum=torch.tensor(edge_sum, dtype=torch.float32, device=dev),
        pops=torch.tensor(pops, dtype=torch.int32, device=dev))
    counters = SparseCounters(lookups=lookups, fallbacks=fallbacks,
                            pair_lookups=pair_lookups, pair_misses=misses)
    return res, d.syncs, w_edges, counters


def _build_lazy(S: torch.Tensor, topk: int) -> Tuple[TMFGResult, int]:
    """The lazy construction on an (n, n) float32 S whose diagonal is -inf.

    Returns the result and the number of device->host syncs it made."""
    n = S.shape[0]
    table = candidate_table(S, min(topk, n)) if topk and topk > 0 else None
    res, syncs, _, _ = lazy_loop(_Device(S, table))
    return res, syncs


def prepare_similarity(S: torch.Tensor) -> torch.Tensor:
    """float32 copy of S with the diagonal set to -inf (S is not changed)."""
    S = S.to(torch.float32, copy=True)
    S.fill_diagonal_(NEG)
    return S


def build_tmfg(S: torch.Tensor, *, method: str = "lazy", prefix: int = 10,
               topk: int = 0) -> TMFGResult:
    """Construct the TMFG of a similarity matrix.

    Args:
      S: (n, n) symmetric similarity tensor (diagonal ignored), on the
        device the construction runs on.
      method: "lazy" (the paper's HEAP-TMFG).  "corr" and "orig" raise
        NotImplementedError until ROADMAP Queue 1 item 2 ports them.
      prefix: prefix size P for method="orig" (unused by "lazy").
      topk: if > 0, build an (n, topk) candidate table up front and use
        it for the lookups; 0 disables (full row scans).
    """
    del prefix
    if method != "lazy":
        if method in ("corr", "orig"):
            raise not_ported("method", method)
        raise ValueError(f"unknown method {method!r}")
    res, _ = _build_lazy(prepare_similarity(S), topk)
    return res


def tmfg_adjacency(n: int, edges: torch.Tensor,
                   S: torch.Tensor) -> torch.Tensor:
    """Dense weighted adjacency (0 where no edge) from a TMFG edge list."""
    e = edges.long()
    return adjacency_from_weights(n, edges, S[e[:, 0], e[:, 1]])


def adjacency_from_weights(n: int, edges: torch.Tensor,
                           w: torch.Tensor) -> torch.Tensor:
    """Dense weighted adjacency from per-edge weights (3n-6,)."""
    e = edges.long()
    A = torch.zeros((n, n), dtype=w.dtype, device=w.device)
    A[e[:, 0], e[:, 1]] = w
    A[e[:, 1], e[:, 0]] = w
    return A
