"""The port's kernels (``repro_torch.kernels``) against the JAX package.

On the CPU the port runs each kernel's plain PyTorch version; these tests
hold those against the Pallas kernels in interpret mode and against
``repro.kernels.ref``, on the same numpy inputs:

  * Pearson within 1e-6 absolute (different matmuls round differently);
  * min-plus bitwise, inf entries and ragged shapes included (a minimum
    of exactly rounded sums does not depend on their order);
  * masked argmax bitwise, ties included, and the ref's (-inf, 0) on
    fully masked rows.

``tests/test_torch_cuda.py`` holds each CUDA kernel against its plain
version on the card.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.gainscan import masked_argmax_pallas  # noqa: E402
from repro.kernels.minplus import minplus_pallas  # noqa: E402
from repro.kernels.pearson import pearson_pallas  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# Pearson
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,L", [(8, 16), (45, 70), (33, 46), (64, 128)])
def test_pearson_matches_pallas_and_ref(n, L):
    X = _rng(n * L).normal(size=(n, L)).astype(np.float32)
    got = ref.pearson_ref(torch.from_numpy(X)).numpy()
    pallas = np.asarray(pearson_pallas(jnp.asarray(X), bm=16, bn=16, bl=32,
                                       interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jref.pearson_ref(
        jnp.asarray(X))), rtol=0, atol=1e-6)


def test_standardize_rows_matches_ref():
    X = _rng(1).normal(size=(20, 33)).astype(np.float32)
    np.testing.assert_allclose(
        ref.standardize_rows(torch.from_numpy(X)).numpy(),
        np.asarray(jref.standardize_rows(jnp.asarray(X))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 127, 128, 129, 300])
def test_pearson_plan_covers_every_pair_once(n):
    """The kernel's upper-triangle tiles, each writing its owned row
    segments and (off the diagonal) its owned column segments as rows of
    the transposed copy, cover every (i, j) of the output exactly once;
    every segment lies in the tile's computed window and starts and ends
    on a 32-byte sector boundary of out's memory (but at column 0 and n).
    On the launch grid and on grids of fewer blocks, each of which then
    walks several tiles by counters (at own = 8, n = 300 has three
    super-tiles of 16 x 16 tiles a side, ragged)."""
    from repro_torch.kernels import pearson
    for own in (None, 12, 8):
        pl = pearson.plan(n, 46, own=own)
        assert pl.own % 4 == 0
        assert pl.computed == pl.own + (4 if n % 4 == 0 else 8)
        assert (pl.nb - 1) * pl.own < n <= pl.nb * pl.own
        assert pl.Np % 32 == 0 and pl.Np >= (pl.nb - 1) * pl.own + pl.computed
        assert pl.tiles == pl.nb * (pl.nb + 1) // 2
        assert pl.grid == min(2 * 132, pl.tiles)
        if own is None:
            assert pl.computed == 128
        order = pearson.tile_order(pl.nb)
        for grid in sorted({pl.grid, 1, min(5, pl.tiles)}):
            count = np.zeros((n, n), np.int64)
            walked = []
            for b in range(grid):
                tiles = pearson.block_tiles(pl.nb, grid, b)
                assert tiles == order[b::grid]
                walked += tiles
                for bi, bj in tiles:
                    assert bi <= bj
                    copies = [(bi, bj)] + ([(bj, bi)] if bi != bj else [])
                    for tr, tc in copies:
                        r0, c0 = tr * pl.own, tc * pl.own
                        for g in range(r0, min(r0 + pl.own, n)):
                            c, e = pearson.row_segment(n, pl.own, g, tc)
                            assert 0 <= c - c0 and e - c0 <= pl.computed
                            assert c == 0 or (g * n + c) % 8 == 0
                            assert e == n or (g * n + e) % 8 == 0
                            count[g, c:e] += 1
            assert len(set(walked)) == len(walked) == pl.tiles
            assert (count == 1).all()


def test_pearson_plan_at_crop():
    """Crop (19412, 46): tiles computing 128 x 128 and owning 124 (rows
    are 16-byte aligned), 157 a side, 12,403 of the 24,649 computed, on
    one wave of two blocks per SM; a ragged n owns 120."""
    from repro_torch.kernels import pearson
    assert pearson.plan(19412, 46) == (48, 19488, 124, 128, 157, 12403, 264)
    assert pearson.plan(2400, 1024) == (1024, 2496, 124, 128, 20, 210, 210)
    assert pearson.plan(2911, 46)[2:5] == (120, 128, 25)


@pytest.mark.parametrize("n,L,own,grid", [
    (8, 16, None, None), (45, 70, 8, None), (33, 46, 8, 2),
    (64, 128, 12, 3), (300, 46, None, None), (129, 17, 24, 4),
    (131, 46, 12, 7)])
def test_pearson_tiles_ref_symmetric_and_matches_pallas(n, L, own, grid):
    """The twin of the kernel's schedule is exactly symmetric and within
    1e-6 of the Pallas kernel and of the plain Pearson."""
    from repro_torch.kernels import pearson
    X = _rng(n * L + (own or 0)).normal(size=(n, L)).astype(np.float32)
    X[1::5] = X[0]                       # exact +-1 entries off the diagonal
    got = pearson.pearson_tiles_ref(torch.from_numpy(X), own=own, grid=grid)
    assert torch.equal(got, got.T)
    pallas = np.asarray(pearson_pallas(jnp.asarray(X), bm=16, bn=16, bl=32,
                                       interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(),
                               ref.pearson_ref(torch.from_numpy(X)).numpy(),
                               rtol=0, atol=1e-6)


def test_pearson_dispatch_on_cpu():
    X = torch.from_numpy(_rng(2).normal(size=(12, 30)).astype(np.float32))
    assert torch.equal(ops.pearson(X), ref.pearson_ref(X))
    assert torch.equal(ops.pearson(X, backend="torch"), ref.pearson_ref(X))
    with pytest.raises(ValueError, match="CUDA device"):
        ops.pearson(X, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        ops.pearson(X, backend="pallas")


# ---------------------------------------------------------------------------
# min-plus
# ---------------------------------------------------------------------------

def _dist(rng, shape, inf_frac):
    A = rng.uniform(0, 5, shape).astype(np.float32)
    if inf_frac:
        A[rng.random(shape) < inf_frac] = np.inf
    return A


@pytest.mark.parametrize("m,k,n", [(8, 8, 8), (17, 33, 9), (1, 50, 1),
                                   (64, 64, 64), (130, 7, 127),
                                   # the CUDA kernel's tile edges: 140 rows
                                   # over a short k, k = 140, odd n
                                   (140, 40, 33), (33, 140, 31)])
@pytest.mark.parametrize("inf_frac", [0.0, 0.3])
def test_minplus_bitwise(m, k, n, inf_frac):
    rng = _rng(m * 1000 + k * 10 + n)
    A, B = _dist(rng, (m, k), inf_frac), _dist(rng, (k, n), inf_frac)
    got = ref.minplus_ref(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    want = np.asarray(jref.minplus_ref(jnp.asarray(A), jnp.asarray(B)))
    pallas = np.asarray(minplus_pallas(jnp.asarray(A), jnp.asarray(B), bm=16,
                                       bk=8, bn=16, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    # the k-panel only bounds memory: every panel gives the same bits
    for panel in (1, 5):
        np.testing.assert_array_equal(ref.minplus_ref(
            torch.from_numpy(A), torch.from_numpy(B), panel=panel).numpy(),
            got)
    np.testing.assert_array_equal(
        ops.minplus(torch.from_numpy(A), torch.from_numpy(B)).numpy(), got)


def test_minplus_propagates_nan_as_pallas():
    """A NaN operand reaches every output it is summed into, at the same
    places as in the Pallas kernel (jnp.min / jnp.minimum)."""
    rng = _rng(5)
    A, B = _dist(rng, (17, 33), 0.3), _dist(rng, (33, 9), 0.3)
    A[3, 7] = B[20, 2] = B[0, 5] = np.nan
    got = ops.minplus(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    want = np.asarray(minplus_pallas(jnp.asarray(A), jnp.asarray(B), bm=16,
                                     bk=8, bn=16, interpret=True))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got, want)     # NaN compares equal here
    assert np.isnan(got[3]).all() and np.isnan(got[:, 2]).all()


def test_minplus_neg_inf_meets_inf_as_pallas():
    """-inf + inf is NaN: where a -inf of A meets a +inf of B the plain
    version (the card tests' oracle) has NaN at the Pallas kernel's and
    the JAX oracle's places; elsewhere a -inf gives -inf."""
    rng = _rng(11)
    A, B = _dist(rng, (140, 36), 0.3), _dist(rng, (36, 35), 0.3)
    A[5, :] = 1.0
    A[5, 3] = -np.inf
    B[3, :4], B[3, 4:] = np.inf, 2.0
    got = ref.minplus_ref(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    pallas = np.asarray(minplus_pallas(jnp.asarray(A), jnp.asarray(B), bm=16,
                                       bk=8, bn=16, interpret=True))
    want = np.asarray(jref.minplus_ref(jnp.asarray(A), jnp.asarray(B)))
    assert np.isnan(got[5, :4]).all() and np.isneginf(got[5, 4:]).all()
    np.testing.assert_array_equal(got, pallas)   # NaN compares equal here
    np.testing.assert_array_equal(got, want)


def test_minplus_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="inner sizes"):
        ref.minplus_ref(torch.zeros(3, 4), torch.zeros(5, 3))


# ---------------------------------------------------------------------------
# masked argmax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n", [(8, 8), (13, 40), (40, 600)])
def test_masked_argmax_bitwise_with_ties(m, n):
    rng = _rng(m + n)
    S = rng.integers(0, 4, (m, n)).astype(np.float32)   # many ties
    mask = rng.random(n) < 0.5
    mask[rng.integers(0, n)] = False                     # one open column
    vals, idx = ref.masked_argmax_ref(torch.from_numpy(S),
                                      torch.from_numpy(mask))
    pv, pi = masked_argmax_pallas(jnp.asarray(S), jnp.asarray(mask), bm=8,
                                  bn=16, interpret=True)
    rv, ri = jref.masked_argmax_ref(jnp.asarray(S), jnp.asarray(mask))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(pv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pi))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    assert idx.dtype == torch.int32 and vals.dtype == torch.float32


def test_masked_argmax_fully_masked_rows_match_ref():
    S = _rng(3).normal(size=(6, 10)).astype(np.float32)
    mask = np.ones(10, bool)
    vals, idx = ops.masked_argmax(torch.from_numpy(S), torch.from_numpy(mask))
    rv, ri = jref.masked_argmax_ref(jnp.asarray(S), jnp.asarray(mask))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    assert np.isneginf(vals.numpy()).all() and (idx.numpy() == 0).all()


# ---------------------------------------------------------------------------
# build and binding (checked without a compiler)
# ---------------------------------------------------------------------------

_C_ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)


def test_every_kernel_has_a_matching_c_entry_point():
    """Each wrapper's ctypes signature matches its C entry point: the
    pointer/int/float parameters in order, then the stream."""
    entries = {}
    for src in _build.sources():
        for name, params in _C_ENTRY.findall(src.read_text()):
            kinds = ["p" if "*" in p else "f" if "float" in p else "i"
                     for p in params.split(",")]
            entries[name] = "".join(kinds)
    assert {p.name for p in _build.sources()} == {
        "pearson.cu", "minplus.cu", "masked_argmax.cu", "topk.cu",
        "sparse_relax.cu", "flash_attention.cu",
        "flash_attention_wgmma.cu", "flash_attention_bwd.cu",
        "flash_attention_bwd_wgmma.cu", "flash_attention_bwd_wgmma_wide.cu",
        "flash_attention_bwd_tf32x3.cu"}
    for kname, kern in ops.KERNELS.items():
        assert entries[kern.symbol] == kern.signature + "p", kname


def test_source_hash_tracks_sources_and_flags(monkeypatch):
    h = _build.source_hash()
    assert h == _build.source_hash() and len(h) == 16
    monkeypatch.setattr(_build, "COMPILE_FLAGS", _build.COMPILE_FLAGS + ["-G"])
    assert _build.source_hash() != h


def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing():
    ops.reset_launch_counts()
    from repro_torch.kernels.gainscan import masked_argmax_cuda
    from repro_torch.kernels.minplus import minplus_cuda
    from repro_torch.kernels.pearson import pearson_cuda
    from repro_torch.kernels.sparse_apsp import sparse_relax_cuda
    from repro_torch.kernels.topk import topk_pearson_cuda
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    x = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        pearson_cuda(x)
    with pytest.raises(ValueError, match="CUDA device"):
        minplus_cuda(x, x)
    with pytest.raises(ValueError, match="CUDA device"):
        masked_argmax_cuda(x, torch.zeros(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA device"):
        topk_pearson_cuda(x, 2)
    i = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        sparse_relax_cuda(x, i, i[:0], torch.zeros(0))
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_cuda(q, q, q)
    q = q.bfloat16()
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_bwd_cuda(q, q, q, q, q)
    with pytest.raises(TypeError, match="takes 9 arguments"):
        ops.KERNELS["pearson"].launch(1, 2, stream=0)
    assert ops.launch_counts() == {"pearson": 0, "minplus": 0,
                                   "masked_argmax": 0, "topk": 0,
                                   "sparse_relax": 0, "flash_attention": 0,
                                   "flash_attention_wgmma": 0,
                                   "flash_attention_bwd_rows": 0,
                                   "flash_attention_bwd_dkdv": 0,
                                   "flash_attention_bwd_dq": 0,
                                   "flash_attention_bwd_wgmma_dq": 0,
                                   "flash_attention_bwd_wgmma_dkdv": 0,
                                   "flash_attention_bwd_wide_dq": 0,
                                   "flash_attention_bwd_wide_dkdv": 0,
                                   "flash_attention_bwd_tf32x3_dq": 0,
                                   "flash_attention_bwd_tf32x3_dkdv": 0}


def test_topk_plan_fits_shared_memory():
    """The top-K kernel's launch plan: two blocks per SM in every case
    (each block within 227 KB and both within the SM's 228 KB); the
    candidate lists in shared memory beside 64 staging pairs per row for
    k up to 64 (two per lane of the warp that merges them) and n up to
    2**25, in device memory only beyond; at the Crop shape one whole
    wave of 264 blocks, each an equal run of the (panel, tile)
    sequence."""
    from repro_torch.kernels import topk
    crop = topk.plan(19412, 46, 64)
    assert crop == (48, 19456, 304, 152, 264, 64, True, 103168)
    assert crop.smem == topk.smem_bytes(True, 64, 64) == 4 * (
        3 * 16 * (64 + 128) + 3 * 64) + 8 * (64 * 64 + 64 * 64)
    per_block = topk.SM_SMEM // 2 - topk.BLOCK_RESERVED
    for n, L, k in ((2, 3, 1), (65, 46, 64), (2000, 46, 1), (2000, 46, 64),
                    (2000, 46, 65), (2000, 46, 1999), (1000, 200, 999),
                    (5000, 3, 4000), (1370, 2709, 64), (2400, 1024, 64),
                    (2400, 100000, 2399), (19412, 46, 19411)):
        pl = topk.plan(n, L, k)
        assert pl.smem <= topk.MAX_SMEM and pl.smem <= per_block
        assert pl.Lp % 16 == 0 and pl.Lp - 16 < L <= pl.Lp
        assert pl.Np % 128 == 0 and pl.Np - 128 < n <= pl.Np
        assert pl.panels * 64 >= n and pl.col_tiles * 128 == pl.Np
        # each row keeps k listed pairs and stages at least a half tile
        assert pl.sc >= 64 and pl.sc & (pl.sc - 1) == 0
        assert topk.smem_bytes(True, 64, min(k, 64)) <= per_block
        assert pl.shared_lists == (k <= 64)
        if pl.shared_lists:
            assert pl.sc == 64 and pl.grid == min(264, pl.tiles)
        else:
            assert pl.sc == 1024 and pl.grid == min(264, pl.panels)
            assert pl.smem == topk.smem_bytes(False, 1024, k)
    # the shared lists' merge keys hold a column in 25 bits
    assert topk.plan(1 << 25, 2, 64).shared_lists
    assert not topk.plan((1 << 25) + 1, 2, 64).shared_lists
    # whole waves: 264 runs of 175 or 176 tiles, two or three panels each
    runs, pieces = {}, {}
    for b, p, c0, c1 in topk.stream_k_pieces(304, 152, 264):
        runs[b] = runs.get(b, 0) + c1 - c0
        pieces[b] = pieces.get(b, 0) + 1
    assert len(runs) == 264 and set(runs.values()) == {175, 176}
    assert set(pieces.values()) == {2, 3} and sum(runs.values()) == crop.tiles
