"""TMFG construction in PyTorch: every builder of ``repro.core.tmfg``
as a loop that lives on the device.

Three methods, as in the reference (:func:`build_tmfg`):

  * ``"lazy"`` -- the paper's HEAP-TMFG, with or without the up-front
    top-K candidate table (the OPT and HEAP variants), over a value
    source: dense S here (``_Device``), or the table-first source of the
    sparse build (``repro_torch.approx.sparse_tmfg``);
  * ``"corr"`` -- CORR-TMFG (Algorithm 1), n - 4 eager steps, each with
    a full masked row argmax of S (``ops.masked_argmax``: the CUDA
    kernel on the card);
  * ``"orig"`` -- Yu & Shun's ORIG-TMFG with prefix P, rounds of (F, n)
    face-row argmaxes (the same kernel, in row panels), a per-vertex
    dedupe and up to P inserts.

The reference runs each as one ``lax.while_loop`` / ``fori_loop``.  The
port keeps the whole construction state on the device as well (``_State``:
faces, gains, cached best vertices, edges, bubbles, insertion order,
counters) and writes every step without a branch on a device value: a
lazy step pops with ``argmax(gains)``, computes both the stale refresh
and the insert, and selects with ``torch.where``; a write that must not
happen -- the insert's on a stale pop, every write once all n vertices
are in -- goes to a trash slot, one extra row of faces, edges, bubbles
and vertices, cut off at the end.  A step past the end is therefore an
exact no-op.

:func:`run_loop` drives the lazy step.  On a card the loop program
(below) captures ``STEPS_PER_SYNC`` (T) steps in one CUDA graph and
replays it until the inserted count, read once per replay, reaches n;
on the CPU, and in :func:`lazy_build`, the same step runs eagerly and
the count is read every T steps.  A build makes
about ``ceil(pops / T) + 1`` host syncs (the returned count): the flag
reads and one download of the edge values and counters.  CORR has a
fixed step count and reads nothing until the end; ORIG reads the flag
every ``ORIG_ROUNDS_PER_SYNC`` rounds.  A capture or replay that fails
raises: there is no host fallback.

The lazy loop is held as a :class:`LoopProgram` in the bounded cache of
``core/jitcache.py``, keyed by (builder, n, K, T, device), the port's
counterpart of a cached XLA executable: the source's buffers (S and the
candidate table for the dense source; the table, its values and the
exact-value source for the table-first one), the state's buffers and, on
a card, the CUDA graph captured over them.  A build copies its inputs
into the buffers (the pipeline's Pearson kernel writes S there
directly), resets the state in place to what ``_init_state`` gives and
replays: one capture per shape instead of one per build, bitwise the
same result.  A program that misses evicts the other programs on its
device, so the cache holds one set of source buffers per device.
Building a program counts in ``obs.trace.compile_stats``.

The arithmetic that decides the result is the reference's: face gains
summed in its order ((s0 + s1) + s2), ties to the lowest index
(``torch.argmax`` returns the first maximum; the candidate table and
ORIG's top-P come from stable descending sorts, like ``lax.top_k``), the
clique from the (64, n) panels of :func:`panel_row_sums` and a stable
sort, and the edge sum added one edge at a time in float32, on the host,
from the downloaded per-edge values.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.obs import trace as obs_trace

from . import jitcache

NEG = float("-inf")

# T: lazy steps per captured CUDA graph (per flag read on the CPU); the
# sweep over {16, 64, 256} is in PERF.md (tools/tmfg_loop_bench.py)
STEPS_PER_SYNC = 64
# ORIG rounds between two reads of the inserted count
ORIG_ROUNDS_PER_SYNC = 4
# elements per (rows, n) panel of ORIG's face-row sums (256 MiB of f32)
ORIG_PANEL_ELEMS = 1 << 26

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
    """The values a construction reads, and the ``inserted`` mask its
    lookups read (a view of the state's (n + 1,) mask, whose last entry
    is the trash slot).

    A value source (``_Device`` here, the table-first source in
    ``repro_torch.approx.sparse_tmfg``) adds:

      * ``row_sums()``    -- (n,) finite row sums for the clique choice;
      * ``seed_lookup(W)`` -- the clique corners' first best vertices;
      * ``lookup(W)``     -- (best uninserted vertex per row of W,
                             fallback count or None);
      * ``values(r, c)``  -- (S[r, c], miss count or None).

    Every method is a fixed sequence of device operations on device
    index tensors: none reads a device value on the host, so a lazy
    step can be captured in a CUDA graph.
    """

    def __init__(self, n: int, dev: torch.device):
        self.n = n
        self.device = dev
        self.mask = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        self.inserted = self.mask[:n]
        self._faces = {len(p): self._const(p)
                       for p in (_CLIQUE_FACES, _INSERT_FACES, _STALE_FACES)}
        self.clique_edges = self._const(_CLIQUE_EDGES)

    def _const(self, rows) -> torch.Tensor:
        """A small index constant on the device."""
        return torch.tensor(rows, dtype=torch.int64).to(self.device)

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
        computed and selected with ``torch.where``."""
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


class _State(NamedTuple):
    """The construction state on the device, the reference's ``_State``.

    Scalars are (1,) int64 tensors; every indexed field has one trash
    row past its end (faces F, edges E, bubbles B, vertices n) that
    takes the writes a step must not make.  Fields are updated in place,
    so a captured graph reads and writes the same storage."""

    inserted: torch.Tensor       # (n+1,) bool — the source's mask
    n_inserted: torch.Tensor     # (1,)
    gains: torch.Tensor          # (F+1,) f32 — cached gain per face slot
    best_v: torch.Tensor         # (F+1,) — cached best vertex per face
    faces: torch.Tensor          # (F+1, 3)
    face_bubble: torch.Tensor    # (F+1,)
    n_faces: torch.Tensor        # (1,)
    edges: torch.Tensor          # (E+1, 2)
    w_edges: torch.Tensor        # (E+1,) f32 — S value of each edge
    n_edges: torch.Tensor        # (1,)
    insert_order: torch.Tensor   # (n+1,)
    bubble_verts: torch.Tensor   # (B+1, 4)
    bubble_parent: torch.Tensor  # (B+1,)
    bubble_tri: torch.Tensor     # (B+1, 3)
    home_bubble: torch.Tensor    # (n+1,)
    pops: torch.Tensor           # (1,)
    fallbacks: torch.Tensor      # (1,) — lookups that needed a true row
    misses: torch.Tensor         # (1,) — pair values outside the table
    maxcorr: Optional[torch.Tensor] = None   # (n,) — CORR's cache


def _init_state(d: _Source) -> _State:
    """The reference's ``_init_state``, on the device: the clique of the
    4 largest finite row sums, its 6 edges and 4 faces, and the faces'
    (best vertex, gain) from the corners' seed lookups."""
    n, dev = d.n, d.device
    F, E, B = 2 * n - 4, 3 * n - 6, n - 3
    top4 = torch.sort(d.row_sums(), descending=True, stable=True)[1][:4]
    clique = torch.sort(top4)[0]
    d.mask.index_fill_(0, clique, True)

    def z(*shape, fill=0):
        return torch.full(shape, fill, dtype=torch.int64, device=dev)

    faces = z(F + 1, 3)
    faces[:4] = clique[d._faces[4]]
    ei = clique[d.clique_edges]                          # (6, 2) vertices
    edges = z(E + 1, 2)
    edges[:6] = ei
    w_edges = torch.zeros(E + 1, dtype=torch.float32, device=dev)
    ev, miss_e = d.values(ei[:, 0], ei[:, 1])
    w_edges[:6] = ev
    best, gain, miss = d.pairs(clique, d.seed_lookup(clique), 4)
    gains = torch.full((F + 1,), NEG, dtype=torch.float32, device=dev)
    gains[:4] = gain
    best_v = z(F + 1)
    best_v[:4] = best
    insert_order = z(n + 1)
    insert_order[:4] = clique
    bubble_verts = z(B + 1, 4)
    bubble_verts[0] = clique
    misses = z(1)
    for c in (miss, miss_e):
        if c is not None:
            misses += c
    return _State(
        inserted=d.mask, n_inserted=z(1, fill=4), gains=gains,
        best_v=best_v, faces=faces, face_bubble=z(F + 1), n_faces=z(1, fill=4),
        edges=edges, w_edges=w_edges, n_edges=z(1, fill=6),
        insert_order=insert_order, bubble_verts=bubble_verts,
        bubble_parent=z(B + 1, fill=-1), bubble_tri=z(B + 1, 3, fill=-1),
        home_bubble=z(n + 1), pops=z(1), fallbacks=z(1), misses=misses)


def _insert_one(st: _State, f, v, face, ev, ok) -> None:
    """The reference's ``_insert_one`` where ``ok`` (1,) holds: insert
    vertex v (1,) into face slot f (1,) with corners ``face`` (3,) and
    edge values ``ev`` (3,) = S[v, face].  Where it does not, every
    write goes to the trash slots and the counts stay."""
    n = st.inserted.shape[0] - 1
    F = st.gains.shape[0] - 1
    E = st.w_edges.shape[0] - 1
    B = st.bubble_parent.shape[0] - 1
    k = st.n_inserted
    bub = k - 3            # bubble ids: 0 = root clique, then one per insert
    vs = torch.where(ok, v, n)
    fs = torch.where(ok, torch.cat([f, st.n_faces, st.n_faces + 1]), F)
    es = torch.where(ok, torch.cat([st.n_edges, st.n_edges + 1,
                                    st.n_edges + 2]), E)
    bs = torch.where(ok, bub, B)
    st.inserted.index_fill_(0, vs, True)
    st.insert_order.index_copy_(0, torch.where(ok, k, n), v)
    st.edges.index_copy_(0, es, torch.stack([v.expand(3), face], dim=1))
    st.w_edges.index_copy_(0, es, ev)
    st.bubble_verts.index_copy_(0, bs, torch.cat([v, face]).view(1, 4))
    st.bubble_parent.index_copy_(0, bs, st.face_bubble.index_select(0, f))
    st.bubble_tri.index_copy_(0, bs, face.view(1, 3))
    st.home_bubble.index_copy_(0, vs, bub)
    # face slot f is overwritten with (v,a,b); (v,b,c) and (v,a,c) appended
    st.faces.index_copy_(0, fs, torch.stack([
        torch.cat([v, face[0:2]]), torch.cat([v, face[1:3]]),
        torch.cat([v, face[0:1], face[2:3]])]))
    st.face_bubble.index_copy_(0, fs, bub.expand(3))
    st.n_inserted.add_(ok)
    st.n_faces.add_(2 * ok)
    st.n_edges.add_(3 * ok)


def _add_counts(acc: torch.Tensor, *terms) -> None:
    """acc += count where mask, for each (mask, count) whose count exists."""
    for mask, count in terms:
        if count is not None:
            acc.add_(torch.where(mask, count, 0))


def _pop(st: _State):
    """The vectorized heap-pop: (face slot f, its cached vertex v, its
    corners (3,)), all on the device."""
    F = st.gains.shape[0] - 1
    f = st.gains[:F].argmax().view(1)
    return (f, st.best_v.index_select(0, f),
            st.faces.index_select(0, f).view(3))


def lazy_step(st: _State, d: _Source) -> None:
    """One pop of the lazy construction (the reference's ``body``),
    with no branch on a device value: both the stale refresh and the
    insert are computed, each with the reference's lookups and pairs,
    and ``torch.where`` keeps the one that applies.

    The state holds no maxcorr cache: the reference reads it only for
    the corners of a face whose lookups it has just refreshed, so each
    branch recomputes those corners' lookups instead."""
    n, F = d.n, st.gains.shape[0] - 1
    f, v, face = _pop(st)
    stale = st.inserted.index_select(0, v)
    live = st.n_inserted < n
    ins, ref = live & ~stale, live & stale
    slots = torch.cat([f, st.n_faces, st.n_faces + 1])
    ev, miss_e = d.values(v.expand(3), face)
    _insert_one(st, f, v, face, ev, ins)
    # stale: re-validate the face's corners (Alg. 2 else-branch); v is
    # inserted, so the mask is the one the reference's refresh reads
    mc, fb_r = d.lookup(face)
    b_r, g_r, miss_r = d.pairs(face, mc, 1)
    # insert: the 3 new faces' pairs from the 4 refreshed corners
    W = torch.cat([v, face])
    mc, fb_i = d.lookup(W)
    b_i, g_i, miss_i = d.pairs(W, mc, 3)
    tgt = torch.cat([torch.where(live, f, F), torch.where(ins, slots[1:], F)])
    st.best_v.index_copy_(0, tgt, torch.where(ins, b_i, b_r))
    st.gains.index_copy_(0, tgt, torch.where(ins, g_i, g_r))
    st.pops.add_(live)
    _add_counts(st.fallbacks, (ins, fb_i), (ref, fb_r))
    _add_counts(st.misses, (ins, miss_i), (ins, miss_e), (ref, miss_r))


def capture(step, T: int, dev: torch.device) -> torch.cuda.CUDAGraph:
    """One eager ``step()`` on a side stream (a real step; it sets up the
    libraries' per-stream state), then T steps captured in one CUDA
    graph; replaying the graph runs the next T steps."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        step()
        graph.capture_begin()
        for _ in range(T):
            step()
        graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    return graph


def run_loop(step, st: _State, n: int, T: Optional[int] = None) -> int:
    """Call ``step()`` until all n vertices are inserted; T steps (default
    ``STEPS_PER_SYNC``) per read of the inserted count.  ``step`` must
    be an exact no-op once the build is complete (a graph's ``replay``
    with T = 1 runs the captured steps).  Returns the number of count
    reads (host syncs)."""
    T = STEPS_PER_SYNC if T is None else T
    if n <= 4:
        return 0
    syncs = 0
    while True:
        for _ in range(T):
            step()
        syncs += 1
        if int(st.n_inserted) >= n:
            return syncs


def _f32_sum(vals: np.ndarray) -> np.float32:
    """Sequential float32 sum from 0, one term at a time (the reference's
    order: ``np.add.accumulate`` does not reassociate)."""
    return np.add.accumulate(vals.astype(np.float32), dtype=np.float32)[-1]


def _finish(st: _State, n: int):
    """TMFGResult (the trash rows cut off, int32), the per-edge values
    (3n-6,) f32 on the device, and (pops, fallbacks, misses) as host
    ints, from one download of the edge values and counters."""
    F, E, B = 2 * n - 4, 3 * n - 6, n - 3
    w = st.w_edges[:E].clone()
    got = torch.cat([w.double(), st.pops.double(), st.fallbacks.double(),
                     st.misses.double()]).cpu().numpy()
    pops, fallbacks, misses = (int(x) for x in got[E:])

    def i32(t):
        return t.to(torch.int32)

    res = TMFGResult(
        clique=i32(st.insert_order[:4]), edges=i32(st.edges[:E]),
        faces=i32(st.faces[:F]), insert_order=i32(st.insert_order[:n]),
        bubble_verts=i32(st.bubble_verts[:B]),
        bubble_parent=i32(st.bubble_parent[:B]),
        bubble_tri=i32(st.bubble_tri[:B]), home_bubble=i32(st.home_bubble[:n]),
        edge_sum=torch.tensor(_f32_sum(got[:E]), dtype=torch.float32,
                              device=w.device),
        pops=i32(st.pops[0]))
    return res, w, (pops, fallbacks, misses)


def _lazy_result(st: _State, n: int, syncs: int):
    """(TMFGResult, host syncs with the final download, per-edge values,
    SparseCounters) of a finished lazy loop."""
    res, w, (pops, fallbacks, misses) = _finish(st, n)
    ins = n - 4
    counters = SparseCounters(
        lookups=3 * (pops - ins) + 4 * ins, fallbacks=fallbacks,
        pair_lookups=6 + 9 * 4 + 9 * (pops - ins) + (3 + 27) * ins,
        pair_misses=misses)
    return res, syncs + 1, w, counters


def lazy_build(d: _Source):
    """The lazy construction over any value source ``d``, uncached: a
    fresh state and eager steps, on a card too (the loop program's
    check).

    Returns (TMFGResult, host syncs, per-edge values (3n-6,) float32 in
    edge order, SparseCounters)."""
    n = d.n
    st = _init_state(d)
    syncs = run_loop(lambda: lazy_step(st, d), st, n)
    return _lazy_result(st, n, syncs)


def _reset_state(st: _State, d: _Source) -> None:
    """Set ``st`` back, in place, to what ``_init_state(d)`` gives for
    the values now in the source's buffers."""
    d.mask.zero_()
    fresh = _init_state(d)
    for mine, new in zip(st, fresh):
        if mine is not None and mine is not new:
            mine.copy_(new)


def program_device(dev) -> torch.device:
    """The device a program key names (``cuda`` with its index)."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class LoopProgram:
    """One lazy loop as a reusable program: the value source ``d`` (its
    buffers are the program's inputs), the state's buffers and, on a
    card, the CUDA graph of T steps captured over both — the port's
    counterpart of a cached XLA executable.

    A caller holds ``lock`` from writing the inputs into ``d``'s buffers
    until it is done with them (the results of :meth:`run` are copies,
    so it may let go once it has them); a second caller waits.  The
    first :meth:`run` initialises the state and captures the graph (one
    eager step on a side stream, then T captured): the build, counted
    once in ``obs.trace.compile_stats``.  Every later run resets the
    state in place and replays."""

    def __init__(self, d: _Source, T: int, alloc_s: float = 0.0):
        self.d, self.T = d, T
        self.lock = threading.RLock()
        self.st: Optional[_State] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.alloc_s = alloc_s
        self.build_s = 0.0
        self.capture_s = 0.0
        self.runs = 0

    def nbytes(self) -> int:
        """Bytes of the tensors the program holds (the graph's private
        memory pool not included)."""
        seen = {}
        tensors = [t for t in vars(self.d).values()
                   if isinstance(t, torch.Tensor)]
        tensors += list(self.d._faces.values())
        if self.st is not None:
            tensors += [t for t in self.st if t is not None]
        for t in tensors:
            stor = t.untyped_storage()
            seen[stor.data_ptr()] = stor.nbytes()
        return int(sum(seen.values()))

    def run(self):
        """The lazy construction on the values in ``d``'s buffers:
        (TMFGResult, host syncs, per-edge values, SparseCounters), as
        :func:`lazy_build` returns them.  The caller holds ``lock``."""
        d, n = self.d, self.d.n
        if self.st is None:
            t0 = time.perf_counter()
            self.st = _init_state(d)
            if n > 4 and d.device.type == "cuda":
                st = self.st
                t1 = time.perf_counter()
                self.graph = capture(lambda: lazy_step(st, d), self.T,
                                     d.device)
                torch.cuda.current_stream(d.device).synchronize()
                self.capture_s = time.perf_counter() - t1
            self.build_s = self.alloc_s + time.perf_counter() - t0
            obs_trace.record_compile(
                self.build_s, what=f"tmfg.lazy n={n} T={self.T}")
        else:
            _reset_state(self.st, d)
        self.runs += 1
        st = self.st
        if self.graph is not None:
            syncs = run_loop(self.graph.replay, st, n, 1)
        else:
            syncs = run_loop(lambda: lazy_step(st, d), st, n, self.T)
        return _lazy_result(st, n, syncs)


def cached_program(key: tuple, dev: torch.device,
                   make_source) -> LoopProgram:
    """The program of ``key`` (the builder and its shapes) at
    T = ``STEPS_PER_SYNC`` on ``dev`` from the shared bounded cache, made
    on a miss from ``make_source()`` (a source over fresh buffers) after
    the other programs on ``dev`` are evicted: a caller still running one
    keeps it until it is done, and the cache holds one per device."""
    T = STEPS_PER_SYNC
    full = ("tmfg.lazy",) + key + (T, str(dev))

    def make():
        # one program's source buffers per device: the others go first
        jitcache.evict(lambda k: k[0] == "tmfg.lazy" and k[-1] == full[-1])
        t0 = time.perf_counter()
        d = make_source()
        return LoopProgram(d, T, time.perf_counter() - t0)
    return jitcache.cached(full, make)


def dense_program(n: int, k: int, dev) -> LoopProgram:
    """The cached lazy program of the dense source for an (n, n) S and
    an (n, k) candidate table (k = 0: full row scans), on ``dev``."""
    dev = program_device(dev)

    def make_source():
        S = torch.empty((n, n), dtype=torch.float32, device=dev)
        table = (torch.empty((n, k), dtype=torch.int64, device=dev)
                 if k else None)
        return _Device(S, table)
    return cached_program(("dense", n, k), dev, make_source)


def build_dense(prog: LoopProgram) -> Tuple[TMFGResult, int]:
    """The lazy build on the similarity the caller has written into the
    dense program's ``d.S`` (under ``prog.lock``): its diagonal is set to
    -inf for the build (the candidate table is cut from it) and put back
    afterwards, so S can go on to the DBHT stage.  Returns the result
    and the host syncs."""
    d = prog.d
    diag = d.S.diagonal().clone()
    d.S.fill_diagonal_(NEG)
    if d.table is not None:
        d.table.copy_(candidate_table(d.S, d.table.shape[1]))
    res, syncs, _, _ = prog.run()
    d.S.diagonal().copy_(diag)
    return res, syncs


def _all_face_pairs(S, maxcorr, faces, valid):
    """Vectorized (best vertex, gain) for every face slot, from the
    corners' cached ``maxcorr`` (the reference's ``_all_face_pairs``)."""
    cands = maxcorr[faces]                                   # (F, 3)
    M = S[faces[:, :, None], cands[:, None, :]]              # (F, 3, 3)
    g = (M[:, 0] + M[:, 1]) + M[:, 2]
    j = g.argmax(dim=1, keepdim=True)
    return (cands.gather(1, j)[:, 0],
            torch.where(valid, g.gather(1, j)[:, 0], NEG))


def corr_step(st: _State, d: _Device, slot: torch.Tensor,
              backend: str) -> None:
    """One CORR step (the reference's ``_build_corr`` body): insert the
    best cached pair, then refresh eagerly every face that cached the
    inserted vertex, from fresh maxcorr rows of all their corners."""
    n, F = d.n, slot.shape[0]
    f, v, face = _pop(st)
    affected = (st.best_v[:F] == v) & (slot < st.n_faces)
    slots = torch.cat([f, st.n_faces, st.n_faces + 1])
    ev, _ = d.values(v.expand(3), face)
    _insert_one(st, f, v, face, ev, st.n_inserted < n)
    affected.index_fill_(0, slots, True)
    corners = torch.where(affected[:, None], st.faces[:F], n)
    stale = torch.zeros(n + 1, dtype=torch.bool, device=d.device)
    stale.index_fill_(0, corners.reshape(-1), True)
    _, fresh = ops.masked_argmax(d.S, d.inserted, backend=backend)
    st.maxcorr.copy_(torch.where(stale[:n], fresh.long(), st.maxcorr))
    best, gain = _all_face_pairs(d.S, st.maxcorr, st.faces[:F],
                                 slot < st.n_faces)
    st.best_v[:F] = torch.where(affected, best, st.best_v[:F])
    st.gains[:F] = torch.where(affected, gain, st.gains[:F])
    st.pops.add_(1)


def orig_round(st: _State, d: _Device, slot: torch.Tensor, prefix: int,
               backend: str) -> None:
    """One ORIG round (the reference's ``round_body``): the true best
    vertex of every face, a dedupe by vertex (the max-gain face, lowest
    face on ties), and up to ``prefix`` inserts of the best pairs.  A
    round after the last insert is an exact no-op."""
    n, F = d.n, slot.shape[0]
    live = st.n_inserted < n
    valid = slot < st.n_faces
    per_g = torch.empty(F, dtype=torch.float32, device=d.device)
    per_v = torch.empty(F, dtype=torch.int64, device=d.device)
    rows = max(1, ORIG_PANEL_ELEMS // n)
    for p0 in range(0, F, rows):
        fc = st.faces[p0:min(p0 + rows, F)]
        P = (d.S.index_select(0, fc[:, 0]) + d.S.index_select(0, fc[:, 1])) \
            + d.S.index_select(0, fc[:, 2])
        g, u = ops.masked_argmax(P, d.inserted, backend=backend)
        per_g[p0:p0 + g.shape[0]] = g
        per_v[p0:p0 + g.shape[0]] = u
    # a face past n_faces reads as the reference's all-NEG row
    per_v = torch.where(valid, per_v, 0)
    per_g = torch.where(valid, per_g, NEG)
    seg_max = torch.full((n + 1,), NEG, device=d.device).scatter_reduce_(
        0, per_v, per_g, "amax", include_self=True)
    is_top = valid & (per_g == seg_max[per_v]) & torch.isfinite(per_g)
    seg_face = torch.full((n + 1,), F, dtype=torch.int64,
                          device=d.device).scatter_reduce_(
        0, torch.where(is_top, per_v, n), torch.where(is_top, slot, F),
        "amin", include_self=True)
    winner = is_top & (seg_face[per_v] == slot)
    key = torch.where(winner, per_g, NEG)
    top_f = torch.sort(key, descending=True, stable=True)[1][:prefix]
    top_ok = torch.isfinite(key[top_f])
    for k in range(prefix):
        f = top_f[k:k + 1]
        v = per_v.index_select(0, f)
        face = st.faces.index_select(0, f).view(3)
        ok = (top_ok[k:k + 1] & (st.n_inserted < n)
              & ~st.inserted.index_select(0, v))
        ev, _ = d.values(v.expand(3), face)
        _insert_one(st, f, v, face, ev, ok)
    st.pops.add_(live)


def table_width(topk: int, n: int) -> int:
    """The candidate table's width for ``topk`` (0: no table)."""
    return min(topk, n) if topk and topk > 0 else 0


def _build(S: torch.Tensor, method: str = "lazy", prefix: int = 10,
           topk: int = 0, backend: str = "auto") -> Tuple[TMFGResult, int]:
    """The construction on an (n, n) similarity S, its diagonal ignored
    (S is not changed): the lazy build copies S into its cached program,
    the others into a -inf-diagonal copy.

    Returns the result and the number of device->host syncs it made."""
    n = S.shape[0]
    if method == "lazy":
        prog = dense_program(n, table_width(topk, n), S.device)
        with prog.lock:
            prog.d.S.copy_(S)
            return build_dense(prog)
    if method not in ("corr", "orig"):
        raise ValueError(f"unknown method {method!r}")
    S = prepare_similarity(S)
    d = _Device(S, None)
    st = _init_state(d)
    slot = torch.arange(2 * n - 4, device=S.device)
    syncs = 0
    if method == "corr":
        _, fresh = ops.masked_argmax(S, d.inserted, backend=backend)
        st = st._replace(maxcorr=fresh.long())
        for _ in range(n - 4):
            corr_step(st, d, slot, backend)
    else:
        # a round can never insert more vertices than there are faces:
        # clamp so small graphs accept large paper prefixes (par-200)
        p = min(prefix, 2 * n - 4)
        # eager: a captured round would count its kernel launches once
        syncs = run_loop(lambda: orig_round(st, d, slot, p, backend), st, n,
                         ORIG_ROUNDS_PER_SYNC)
    res, _, _ = _finish(st, n)
    return res, syncs + 1


def prepare_similarity(S: torch.Tensor) -> torch.Tensor:
    """float32 copy of S with the diagonal set to -inf (S is not changed)."""
    S = S.to(torch.float32, copy=True)
    S.fill_diagonal_(NEG)
    return S


def build_tmfg(S: torch.Tensor, *, method: str = "lazy", prefix: int = 10,
               topk: int = 0, backend: str = "auto") -> TMFGResult:
    """Construct the TMFG of a similarity matrix.

    Args:
      S: (n, n) symmetric similarity tensor (diagonal ignored), on the
        device the construction runs on.
      method: "lazy" (the paper's HEAP-TMFG), "corr" (Algorithm 1,
        eager) or "orig" (Yu & Shun's baseline).
      prefix: prefix size P for method="orig".
      topk: if > 0, the lazy lookups read an (n, topk) candidate table
        built up front; 0 disables (full row scans).
      backend: the masked-argmax dispatch of "corr" and "orig"
        (``ops.masked_argmax``: "auto" | "cuda" | "torch").
    """
    res, _ = _build(S, method, prefix, topk, backend)
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
