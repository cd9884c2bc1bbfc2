"""Pearson correlation on the card: the wrapper of ``csrc/pearson.cu``.

Replaces ``repro.kernels.pearson.pearson_pallas``.  As there, the row
statistics (mean and inverse norm) are computed outside the kernel, here
in PyTorch.  The entry point standardises X once into a padded l-major
copy (the scratch ``zt``, as ``csrc/topk.cu`` does), then computes the
upper-triangle tiles of the output on a persistent grid and writes each
off-diagonal tile twice, as itself and transposed, in row segments that
begin and end on 32-byte sector boundaries.  The kernel refuses a
scratch whose shape is not :func:`plan`'s.  See the source note
in ``csrc/pearson.cu`` for the bound and the design.

:func:`plan` fixes the launch with the kernel's own formulas,
:func:`tile_order` is the order of the tiles, :func:`block_tiles` walks
a block's share of it as the kernel does and :func:`row_segment` gives
the columns of a row that a tile owns;
:func:`pearson_tiles_ref` is the plain twin of that schedule, held
against the plain Pearson on the CPU.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from . import _build
from ._checks import require_cuda, require_int32_range, stream_of
from .ref import standardize_rows

# (X, mu, rs, zt, out, n, L, Lp, Np, stream): zt is (Lp, Np)
KERNEL = _build.Kernel("repro_pearson", "pppppiiii")

COMPUTED = 128           # computed tile side (kT in pearson.cu)
STEP = 16                # series elements per step (kBK)
SUPER = 16               # tiles per super-tile side (kS)
SECTOR = 8               # floats per 32-byte sector
BLOCKS_PER_SM = 2
H100_SMS = 132


def row_stats(X: torch.Tensor, eps: float = 1e-12):
    """(mean, 1 / (norm + eps)) of every centred row, as the JAX wrapper
    computes them before its ``pallas_call``."""
    mu = X.mean(dim=1, keepdim=True)
    ss = torch.sum((X - mu) ** 2, dim=1, keepdim=True)
    rs = 1.0 / (torch.sqrt(ss) + eps)
    return mu.reshape(-1).contiguous(), rs.reshape(-1).contiguous()


class PearsonPlan(NamedTuple):
    Lp: int              # L rounded up to a multiple of STEP
    Np: int              # columns of the standardised copy, zero-padded
    own: int             # owned tile side
    computed: int        # computed tile side
    nb: int              # tiles per side
    tiles: int           # upper-triangle tiles, nb (nb + 1) / 2
    grid: int            # blocks of the persistent grid on an H100


def plan(n: int, L: int = 1, own: Optional[int] = None) -> PearsonPlan:
    """The kernel's launch for X (n, L): tiles that compute ``computed``
    x ``computed`` values and own ``own`` rows of each copy (124 of 128
    where n % 4 == 0, whose rows are 16-byte aligned, else 120: a row's
    owned columns start at most 4, or 7, floats past the tile's first
    column, at a sector boundary), the (bi <= bj) tiles of that grid, and
    two blocks per SM of an H100, never more blocks than tiles (the
    kernel reads the SM count from the device).  ``own`` (a multiple of
    4) may be set smaller to walk many tiles at a small n; the kernel
    refuses a scratch of another (Lp, Np) than this plan's."""
    pad = 4 if n % 4 == 0 else 8
    own = own or COMPUTED - pad
    computed = own + pad
    Lp = -(-L // STEP) * STEP
    nb = -(-n // own)
    Np = -(-((nb - 1) * own + computed) // 32) * 32
    tiles = nb * (nb + 1) // 2
    return PearsonPlan(Lp, Np, own, computed, nb, tiles,
                       min(BLOCKS_PER_SM * H100_SMS, tiles))


def row_segment(n: int, own: int, g: int, b: int) -> Tuple[int, int]:
    """[start, end): the columns of row g of the (n, n) output that tile
    column b owns.  Each boundary is the first 32-byte sector boundary of
    the row in memory at or after b * own (column 0 and n at the row's
    ends), so the kernel writes whole sectors only."""
    def boundary(c):
        return c + (-(g * n + c)) % SECTOR
    start = 0 if b == 0 else boundary(b * own)
    return start, min(boundary((b + 1) * own), n)


def tile_order(nb: int, side: int = SUPER) -> List[Tuple[int, int]]:
    """Every (bi <= bj) tile in the kernel's order: super-tiles of side x
    side tiles, the upper triangle of them row-major, and in each its
    tiles row-major (only bi <= bj in a diagonal super-tile)."""
    ns = -(-nb // side)
    out = []
    for si in range(ns):
        for sj in range(si, ns):
            for bi in range(si * side, min((si + 1) * side, nb)):
                for bj in range(max(sj * side, bi),
                                min((sj + 1) * side, nb)):
                    out.append((bi, bj))
    return out


def block_tiles(nb: int, grid: int, b: int,
                side: int = SUPER) -> List[Tuple[int, int]]:
    """The (bi, bj) tiles of block ``b``, in its order: tiles b, b + grid,
    b + 2 grid, ... of :func:`tile_order`, walked by counters as
    ``pearson.cu``'s ``advance`` and ``tile_of`` walk them."""
    ns = -(-nb // side)

    def count(si, sj):
        h, w = min(side, nb - si * side), min(side, nb - sj * side)
        return h * (h + 1) // 2 if si == sj else h * w

    def advance(si, sj, idx, by):
        idx += by
        while si < ns and idx >= count(si, sj):
            idx -= count(si, sj)
            sj += 1
            if sj == ns:
                si += 1
                sj = si
        return si, sj, idx

    def tile_of(si, sj, idx):
        h, w = min(side, nb - si * side), min(side, nb - sj * side)
        if si != sj:
            return si * side + idx // w, sj * side + idx % w
        r = 0
        while idx >= h - r:
            idx -= h - r
            r += 1
        return si * side + r, si * side + r + idx

    out = []
    pos = advance(0, 0, 0, b)
    while pos[0] < ns:
        out.append(tile_of(*pos))
        pos = advance(*pos, grid)
    return out


def pearson_tiles_ref(X: torch.Tensor, eps: float = 1e-12, *,
                      own: Optional[int] = None, grid: Optional[int] = None):
    """The plain twin of the kernel's schedule: Z standardised once into
    an l-major copy zero-padded to (Lp, Np), then every block's tiles,
    each ``T = clip(Zt[:, I].T @ Zt[:, J])`` over the computed rows I and
    columns J, whose owned row segments (:func:`row_segment`) are
    written from T and, off the diagonal, whose owned column segments
    are written from T's transpose as rows.  A diagonal tile keeps its
    upper half and mirrors it, as fmaf's commuting product makes the
    kernel's tile symmetric.  The result is exactly symmetric."""
    n, L = X.shape
    pl = plan(n, L, own=own)
    if grid is None:
        grid = pl.grid
    Z = standardize_rows(X, eps)
    zt = torch.zeros((pl.Lp, pl.Np), dtype=torch.float32, device=X.device)
    zt[:L, :n] = Z.T
    S = torch.empty((n, n), dtype=torch.float32, device=X.device)
    for b in range(grid):
        for bi, bj in block_tiles(pl.nb, grid, b):
            i0, j0 = bi * pl.own, bj * pl.own
            t = torch.clamp(zt[:, i0:i0 + pl.computed].T
                            @ zt[:, j0:j0 + pl.computed], -1.0, 1.0)
            if bi == bj:
                t = torch.triu(t) + torch.triu(t, 1).T
            for g in range(i0, min(i0 + pl.own, n)):
                c, e = row_segment(n, pl.own, g, bj)
                S[g, c:e] = t[g - i0, c - j0:e - j0]
            if bi != bj:
                for g in range(j0, min(j0 + pl.own, n)):
                    c, e = row_segment(n, pl.own, g, bi)
                    S[g, c:e] = t[c - i0:e - i0, g - j0]
    return S


def pearson_cuda(X: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Pearson correlation of the rows of X (n, L) f32 -> (n, n) f32."""
    require_cuda("X", X, torch.float32, 2)
    n, L = X.shape
    require_int32_range(n=n, L=L, nL=n * L)
    pl = plan(n, L)
    mu, rs = row_stats(X, eps)
    zt = torch.empty((pl.Lp, pl.Np), dtype=torch.float32, device=X.device)
    out = torch.empty((n, n), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        KERNEL.launch(X.data_ptr(), mu.data_ptr(), rs.data_ptr(),
                      zt.data_ptr(), out.data_ptr(), n, L, pl.Lp, pl.Np,
                      stream=stream_of(X))
    return out
