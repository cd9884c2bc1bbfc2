"""Streaming top-K Pearson on the card: the wrapper of ``csrc/topk.cu``.

Replaces ``repro.kernels.topk.topk_pearson_pallas``.  Like the Pearson
wrapper, it computes the row statistics (mean and inverse norm) in
PyTorch; the entry point standardises X once into a padded l-major copy
with ``csrc/pearson.cu``'s arithmetic, so every value is bitwise the
entry of ``pearson_cuda(X)`` and the (n, n) matrix never exists.  See
the source note in ``csrc/topk.cu`` for the bound and the design.

:func:`plan` fixes the launch (where the candidate lists live, the grid
and its stream-K split of the (panel, tile) sequence, the shared
memory) with the kernel's own formulas; :func:`merge_pieces_ref` and
:func:`topk_split_ref` are the plain twins of the split and its merge,
held against the plain top-K on the CPU.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from . import _build
from ._checks import require_cuda, require_int32_range, stream_of
from .pearson import row_stats
from .ref import standardize_rows

KERNEL = _build.Kernel("repro_topk", "ppppppppppppiiiiiiiii")

# shared memory of one SM on Hopper (228 KB), and what one block may use
SM_SMEM = 233472
MAX_SMEM = 232448
BLOCKS_PER_SM = 2
BLOCK_RESERVED = 1024            # shared memory the card keeps per block
ROWS = 64                        # rows per panel (kR in topk.cu)
COLS = 128                       # columns per tile (kC)
STEP = 16                        # series elements per step (kBK)
STAGES = 3                       # steps in the copy ring (kStages)
WARPS = 8                        # warps per block (kWarps)
SHARED_STAGE = 64                # staging pairs per row, lists in shared
SHARED_K = 64                    # the largest k with lists in shared
SHARED_MAX_N = 1 << 25           # columns fit the merge keys' 25 bits
GLOBAL_STAGE = 1024              # staging pairs per row, lists in memory
H100_SMS = 132


def smem_bytes(shared_lists: bool, sc: int, k: int) -> int:
    """Dynamic shared memory of one block (topk.cu's smem_bytes): the copy
    ring and the rows' counts and thresholds, then the staging and the
    lists (lists in shared) or each warp's sort buffer."""
    base = 4 * (STAGES * STEP * (ROWS + COLS) + 3 * ROWS)
    if shared_lists:
        return base + 8 * (ROWS * sc + ROWS * k)
    return base + 8 * WARPS * GLOBAL_STAGE


class TopKPlan(NamedTuple):
    Lp: int              # L rounded up to a multiple of STEP
    Np: int              # n rounded up to a multiple of COLS
    panels: int          # ROWS-row panels
    col_tiles: int       # COLS-column tiles per panel
    grid: int            # blocks
    sc: int              # staging pairs per row
    shared_lists: bool   # lists in shared memory (else in vals/idx)
    smem: int            # dynamic shared memory per block

    @property
    def tiles(self) -> int:
        return self.panels * self.col_tiles


def plan(n: int, L: int, k: int, sms: int = H100_SMS,
         rows: Optional[int] = None) -> TopKPlan:
    """The kernel's launch for X (n, L) and k, over ``rows`` rows of the
    table (default all n; the panels are those rows').

    Two blocks fit on an SM in either case.  For k up to 64 the lists
    sit in shared memory beside the staging and are merged in a warp's
    registers; the grid is two blocks per SM, each an equal run of the
    panel-major tile sequence (stream-K), and the pieces are merged by a
    second kernel.  Otherwise the lists live in the output itself and
    each block walks whole panels."""
    Lp = -(-L // STEP) * STEP
    Np = -(-n // COLS) * COLS
    panels = -(-(n if rows is None else rows) // ROWS)
    col_tiles = Np // COLS
    slots = BLOCKS_PER_SM * sms
    if k <= SHARED_K and n <= SHARED_MAX_N:
        return TopKPlan(Lp, Np, panels, col_tiles,
                        min(slots, panels * col_tiles), SHARED_STAGE, True,
                        smem_bytes(True, SHARED_STAGE, k))
    return TopKPlan(Lp, Np, panels, col_tiles, min(slots, panels),
                    GLOBAL_STAGE, False, smem_bytes(False, GLOBAL_STAGE, k))


def stream_k_pieces(panels: int, col_tiles: int, grid: int):
    """The (block, panel, first tile, end tile) pieces of the stream-K
    split: block b walks tiles [b T / G, (b + 1) T / G) of the panel-major
    sequence of T = panels * col_tiles tiles, one piece per panel it
    touches."""
    T = panels * col_tiles
    out = []
    for b in range(grid):
        t, t1 = b * T // grid, (b + 1) * T // grid
        while t < t1:
            p = t // col_tiles
            e = min(t1, (p + 1) * col_tiles)
            out.append((b, p, t - p * col_tiles, e - p * col_tiles))
            t = e
    return out


def merge_pieces_ref(values: List[torch.Tensor], indices: List[torch.Tensor],
                     k: int):
    """The plain twin of topk.cu's merge kernel: the first k of the pieces'
    lists of each row under (value desc, NaN first, index asc).  The
    pieces hold increasing, disjoint column ranges and each is in that
    order already, so a stable descending sort of their concatenation is
    the rank merge."""
    v = torch.cat(values, dim=1)
    i = torch.cat(indices, dim=1)
    sv, order = torch.sort(v, dim=1, descending=True, stable=True)
    return sv[:, :k].contiguous(), torch.gather(i, 1, order[:, :k]).int()


def topk_split_ref(X: torch.Tensor, k: int, *, rows: int = ROWS,
                   cols: int = COLS, grid: Optional[int] = None,
                   row_range: Optional[Tuple[int, int]] = None):
    """The plain twin of the split kernel: the rows' values
    (``clip(Z @ Z.T)``, the diagonal at -inf), each (block, panel) piece's
    stable top-k of its columns, and each row's merge of its pieces.  It
    equals ``ref.topk_pearson_ref`` for any tile shape and grid.

    ``row_range=(row0, count)`` is the kernel's row range: the panels and
    the split walk only those rows, whose keys run over all n columns,
    and the result is those rows of the whole table."""
    n = X.shape[0]
    if not 1 <= k <= n - 1:
        raise ValueError(f"need 1 <= k <= n-1, got k={k} for n={n}")
    row0, count = _check_range(row_range, n)
    Z = standardize_rows(X)
    S = torch.clamp(Z @ Z.T, -1.0, 1.0)
    S.fill_diagonal_(float("-inf"))
    S = S[row0:row0 + count]
    panels, col_tiles = -(-count // rows), -(-n // cols)
    if grid is None:
        grid = min(BLOCKS_PER_SM * H100_SMS, panels * col_tiles)
    parts = {}
    for _, p, c0, c1 in stream_k_pieces(panels, col_tiles, grid):
        r0, j0, j1 = p * rows, c0 * cols, min(c1 * cols, n)
        v, i = torch.sort(S[r0:r0 + rows, j0:j1], dim=1, descending=True,
                          stable=True)
        kk = min(k, j1 - j0)
        parts.setdefault(p, []).append((v[:, :kk], (i[:, :kk] + j0).int()))
    vals, idxs = [], []
    for p in range(panels):
        v, i = merge_pieces_ref([a for a, _ in parts[p]],
                                [b for _, b in parts[p]], k)
        vals.append(v)
        idxs.append(i)
    return torch.cat(vals), torch.cat(idxs)


def _check_range(row_range: Optional[Tuple[int, int]], n: int):
    """(row0, count) of a row range of an n-row table (default: all)."""
    if row_range is None:
        return 0, n
    row0, count = (int(v) for v in row_range)
    if row0 < 0 or count < 1 or row0 + count > n:
        raise ValueError(f"row range ({row0}, {count}) outside 0..{n}")
    return row0, count


def topk_pearson_cuda(X: torch.Tensor, k: int, eps: float = 1e-12,
                      row_range: Optional[Tuple[int, int]] = None):
    """Top-k Pearson partners of each row of X (n, L) f32, the diagonal
    excluded: (values (n, k) f32, indices (n, k) int32), ordered by value
    descending, then index ascending.

    ``row_range=(row0, count)`` computes only rows row0 .. row0 + count - 1
    of that table ((count, k) each), their keys over all n rows of X:
    bitwise those rows of the whole launch."""
    require_cuda("X", X, torch.float32, 2)
    n, L = X.shape
    if not 1 <= k <= n - 1:
        raise ValueError(f"need 1 <= k <= n-1, got k={k} for n={n}")
    row0, count = _check_range(row_range, n)
    require_int32_range(n=n, L=L, nL=n * L, nk=n * k)
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    pl = plan(n, L, k, sms, rows=count)
    mu, rs = row_stats(X, eps)
    dev = X.device
    vals = torch.empty((count, k), dtype=torch.float32, device=dev)
    idx = torch.empty((count, k), dtype=torch.int32, device=dev)
    zt = torch.empty((pl.Lp, pl.Np), dtype=torch.float32, device=dev)
    # the whole table reads its rows from zt; a range from its own copy
    za = zt if count == n else torch.empty(
        (pl.Lp, pl.panels * ROWS), dtype=torch.float32, device=dev)
    if pl.shared_lists:
        pieces = (pl.grid + pl.panels) * ROWS
        buf_v = torch.empty(pieces * k, dtype=torch.float32, device=dev)
        buf_i = torch.empty(pieces * k, dtype=torch.int32, device=dev)
        buf_c = torch.empty(pieces, dtype=torch.int32, device=dev)
        tmp_v = tmp_i = None
    else:
        staged = pl.grid * ROWS * pl.sc
        buf_v = torch.empty(staged, dtype=torch.float32, device=dev)
        buf_i = torch.empty(staged, dtype=torch.int32, device=dev)
        buf_c = None
        tmp_v = torch.empty(pl.grid * WARPS * k, dtype=torch.float32,
                            device=dev)
        tmp_i = torch.empty(pl.grid * WARPS * k, dtype=torch.int32,
                            device=dev)
    ptr = [0 if t is None else t.data_ptr()
           for t in (buf_v, buf_i, buf_c, tmp_v, tmp_i)]
    with torch.cuda.device(dev):
        KERNEL.launch(X.data_ptr(), mu.data_ptr(), rs.data_ptr(),
                      vals.data_ptr(), idx.data_ptr(), zt.data_ptr(),
                      za.data_ptr(), *ptr, n, L, k, row0, count, pl.grid,
                      pl.sc, int(pl.shared_lists), pl.smem,
                      stream=stream_of(X))
    return vals, idx
