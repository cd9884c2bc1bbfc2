"""The port's approx path (``repro_torch.approx`` and
``core/fused_approx.py``) against the JAX package.

  * Top-K tables: the plain ``topk_pearson_ref`` against
    ``topk_pearson_jnp`` and ``topk_pearson_pallas(interpret=True)``:
    indices exact on data without near-ties, values within 1e-6 (PyTorch
    and XLA matmuls round differently).  Tables cut from one S are
    bitwise.
  * The sparse TMFG on JAX's own table: from S every field, the edge
    weights and the counters bitwise; from the standardized series the
    discrete fields and the counters equal and the weights within 1e-6
    (the fallback dot products round otherwise).  At K = n-1 the sparse
    build is bitwise the port's own dense build.
  * The sparse directions bitwise equal to the reference's float64
    oracle and to its fused float32 form on these graphs.
  * ``cluster(config=PipelineConfig.approx(sim_k=32))`` at n=256 (the
    sparse tail) and n=120 (the dense tail), fused and staged, from S and
    from X, against ``repro.core.cluster``: labels and merge structure
    equal; heights bitwise from S and within 1e-4 from X, the dense
    path's rule in tests/test_torch_pipeline.py (a 1e-7 change of rho
    moves sqrt(2(1-rho)) by up to about 1e-5 near rho = 1, and the DBHT
    offsets carry it into the heights).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.approx import knn as jknn  # noqa: E402
from repro.approx import sparse_tmfg as jsparse  # noqa: E402
from repro.core import fused_approx as jfa  # noqa: E402
from repro.core import sparse_dbht as jsdbht  # noqa: E402
from repro.data.timeseries import make_dataset  # noqa: E402
from repro.kernels import topk as jtopk  # noqa: E402
from repro.kernels.ref import pearson_ref as jpearson  # noqa: E402
from repro.kernels.ref import standardize_rows as jstd  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.approx import knn as tknn  # noqa: E402
from repro_torch.approx import sparse_tmfg as tsparse  # noqa: E402
from repro_torch.core import fused_approx as tfa  # noqa: E402
from repro_torch.core import tmfg as ttmfg  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import topk as topk_mod  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _series(n, L=40, seed=0):
    X, _ = make_dataset(n, L, 4, noise=0.8, seed=seed)
    return X


# ---------------------------------------------------------------------------
# top-K tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,L,k", [(30, 40, 7), (48, 64, 47), (100, 46, 32)])
def test_topk_ref_matches_jnp_and_pallas(n, L, k):
    X = np.random.default_rng(n + k).normal(size=(n, L)).astype(np.float32)
    v, i = ref.topk_pearson_ref(torch.from_numpy(X), k)
    jv, ji = jtopk.topk_pearson_jnp(jnp.asarray(X), k)
    pv, pi = jtopk.topk_pearson_pallas(jnp.asarray(X), k, interpret=True)
    for wv, wi in ((jv, ji), (pv, pi)):
        np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
        np.testing.assert_allclose(v.numpy(), np.asarray(wv), rtol=0,
                                   atol=1e-6)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    # panels only bound memory: every panel height gives the same table
    v2, i2 = ref.topk_pearson_ref(torch.from_numpy(X), k, bm=7)
    assert torch.equal(v2, v) and torch.equal(i2, i)


@pytest.mark.parametrize("n,L,k,rows,cols,grid,nan", [
    (40, 20, 10, 8, 8, 7, False),     # pieces cross panel boundaries
    (40, 20, 10, 8, 8, 7, True),      # a NaN series: NaN rows and columns
    (64, 46, 63, 16, 8, 13, False),   # k = n - 1, pieces shorter than k
    (33, 12, 5, 8, 16, 3, True),      # n not a multiple of either tile
    (60, 20, 9, 4, 8, 4, False),      # runs of several whole panels
    (2, 3, 1, 64, 128, 1, False),     # n = 2, one piece
])
def test_topk_split_ref_matches_plain_and_jnp(n, L, k, rows, cols, grid,
                                              nan):
    """The plain twin of the top-K kernel's column split (stream-K runs cut
    into pieces, each a stable top-k of its columns, merged per row by
    rank) equals the
    plain top-K bitwise and JAX's topk_pearson_jnp (indices exact, values
    within 1e-6), with exact ties from duplicated rows across piece
    boundaries and NaN ranked first."""
    rng = np.random.default_rng(n + k + grid)
    X = rng.normal(size=(n, L)).astype(np.float32)
    X[1::7] = X[0]                       # duplicated rows: exact ties
    if nan:
        X[n // 2, 1] = np.nan
    Xt = torch.from_numpy(X)
    v, i = ref.topk_pearson_ref(Xt, k)
    sv, si = topk_mod.topk_split_ref(Xt, k, rows=rows, cols=cols, grid=grid)
    pieces = topk_mod.stream_k_pieces(-(-n // rows), -(-n // cols), grid)
    assert len(pieces) >= min(grid, 2)
    assert sum(c1 - c0 for _, _, c0, c1 in pieces) == \
        -(-n // rows) * -(-n // cols)
    assert torch.equal(si, i) and torch.equal(torch.isnan(sv), torch.isnan(v))
    assert torch.equal(torch.nan_to_num(sv), torch.nan_to_num(v))
    jv, ji = jtopk.topk_pearson_jnp(jnp.asarray(X), k)
    np.testing.assert_array_equal(si.numpy(), np.asarray(ji))
    np.testing.assert_allclose(sv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)


def test_merge_pieces_ref_orders_ties_and_nan():
    """The merge keeps (value desc, NaN first, index asc) across pieces."""
    nan = float("nan")
    a_v = torch.tensor([[nan, 0.5, 0.5, -1.0]])
    a_i = torch.tensor([[3, 0, 2, 1]], dtype=torch.int32)
    b_v = torch.tensor([[nan, 0.5, 0.25]])
    b_i = torch.tensor([[4, 5, 6]], dtype=torch.int32)
    v, i = topk_mod.merge_pieces_ref([a_v, b_v], [a_i, b_i], 5)
    assert i.tolist() == [[3, 4, 0, 2, 5]]
    assert torch.isnan(v[0, :2]).all() and v[0, 2:].tolist() == [0.5] * 3


def test_topk_dispatch_on_cpu_and_shape_checks():
    X = torch.from_numpy(_series(20))
    v, i = ops.topk(X, 5)
    w = ref.topk_pearson_ref(X, 5)
    assert torch.equal(v, w[0]) and torch.equal(i, w[1])
    with pytest.raises(ValueError, match="CUDA device"):
        ops.topk(X, 5, backend="cuda")
    with pytest.raises(ValueError, match="1 <= k <= n-1"):
        ref.topk_pearson_ref(X, 20)
    t = tknn.topk_pearson(X, 50)                 # clamped to n - 1
    assert t.indices.shape == (20, 19)


@pytest.mark.parametrize("n,k", [(30, 7), (40, 39)])
def test_topk_from_similarity_and_densify_bitwise(n, k):
    r = np.random.default_rng(n)
    S = r.integers(0, 5, (n, n)).astype(np.float32) / 4   # many ties
    S = (S + S.T) / 2
    jt = jknn.topk_from_similarity(jnp.asarray(S), k)
    tt = tknn.topk_from_similarity(torch.from_numpy(S), k)
    np.testing.assert_array_equal(tt.values.numpy(), np.asarray(jt.values))
    np.testing.assert_array_equal(tt.indices.numpy(), np.asarray(jt.indices))
    np.testing.assert_array_equal(
        tknn.densify(tt, n=n).numpy(), np.asarray(jknn.densify(jt, n=n)))
    back = interop.table_from_numpy(jt, "cpu")
    assert torch.equal(back.values, tt.values)
    assert torch.equal(back.indices, tt.indices)


def test_topk_pearson_and_z_matches_reference_z():
    X = _series(33)
    t, Z = tknn.topk_pearson_and_z(torch.from_numpy(X), 8)
    np.testing.assert_allclose(Z.numpy(), np.asarray(jstd(jnp.asarray(X))),
                               rtol=0, atol=1e-6)
    assert t.values.shape == (33, 8)


# ---------------------------------------------------------------------------
# the sparse TMFG
# ---------------------------------------------------------------------------

def _assert_tmfg_equal(jres, tres, skip=()):
    for f in jres._fields:
        if f in skip:
            continue
        want = np.asarray(getattr(jres, f))
        got = getattr(tres, f).cpu().numpy()
        assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("n,k", [(60, 8), (60, 59), (100, 2)])
def test_sparse_tmfg_from_S_bitwise(n, k):
    S = np.corrcoef(_series(n, seed=n + k)).astype(np.float32)
    jt = jknn.topk_from_similarity(jnp.asarray(S), k)
    jr, jw, jc = jsparse.build_tmfg_sparse(jt, S=jnp.asarray(S))
    tr, tw, tc = tsparse.build_tmfg_sparse(interop.table_from_numpy(jt, "cpu"),
                                           S=torch.from_numpy(S))
    _assert_tmfg_equal(jr, tr)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert tuple(tc) == tuple(int(x) for x in jc)


@pytest.mark.parametrize("n,k", [(60, 8), (100, 2)])
def test_sparse_tmfg_from_Z_matches(n, k):
    X = _series(n, seed=n + k)
    Z = np.asarray(jstd(jnp.asarray(X)))
    jt = jknn.topk_pearson(jnp.asarray(X), k)
    jr, jw, jc = jsparse.build_tmfg_sparse(jt, Xn=jnp.asarray(Z))
    stats = {}
    tr, tw, tc = tsparse.build_tmfg_sparse(interop.table_from_numpy(jt, "cpu"),
                                           Xn=_t(Z), stats=stats)
    _assert_tmfg_equal(jr, tr, skip=("edge_sum",))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    assert tuple(tc) == tuple(int(x) for x in jc)
    assert tc.fallbacks > 0 and tc.pair_misses > 0
    T = ttmfg.STEPS_PER_SYNC
    assert stats["host_syncs"] <= math.ceil(int(tr.pops) / T) + 3


@pytest.mark.parametrize("n", [40, 80])
def test_sparse_tmfg_at_full_k_is_the_dense_build(n):
    """At K = n-1 every value comes from the table, which holds the dense
    matrix's own values, so the construction is the dense one."""
    X = torch.from_numpy(_series(n, seed=n))
    S = ref.pearson_ref(X)
    dense = ttmfg.build_tmfg(S, topk=64)
    t, Z = tknn.topk_pearson_and_z(X, n - 1)
    P = S.clone()
    P.fill_diagonal_(float("-inf"))
    sv, si = torch.sort(P, dim=1, descending=True, stable=True)
    assert torch.equal(t.values, sv[:, :n - 1])
    assert torch.equal(t.indices, si[:, :n - 1].int())
    sparse, w, c = tsparse.build_tmfg_sparse(t, Xn=Z)
    for f in dense._fields:
        assert torch.equal(getattr(dense, f), getattr(sparse, f)), f
    e = dense.edges.long()
    assert torch.equal(w, S[e[:, 0], e[:, 1]])
    assert c.pair_misses == 0


def test_sparse_tmfg_needs_one_source():
    t = tknn.topk_pearson(torch.from_numpy(_series(10)), 3)
    with pytest.raises(ValueError, match="exactly one"):
        tsparse.build_tmfg_sparse(t)


# ---------------------------------------------------------------------------
# directions from the edge list
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [256])
def test_sparse_directions_match_oracle_and_fused_form(n):
    # the TMFG from the port's sparse build, bitwise JAX's (tested above)
    S = torch.from_numpy(np.corrcoef(_series(n, L=46, seed=n)).astype(
        np.float32))
    tr, tw, _ = tsparse.build_tmfg_sparse(tknn.topk_from_similarity(S, 32),
                                          S=S)
    e, w = tr.edges.numpy(), tw.numpy()
    bp = tr.bubble_parent.numpy()
    bt, hb = tr.bubble_tri.numpy(), tr.home_bubble.numpy()
    oracle = jsdbht._directions_sparse(e, w, bp, bt, hb)
    fused32 = np.asarray(jfa._device_directions_sparse(
        n, jnp.asarray(e), jnp.asarray(w), jnp.asarray(bp), jnp.asarray(bt),
        jnp.asarray(hb)))
    got = tfa._device_directions_sparse(n, _t(e), _t(w), _t(bp), _t(bt),
                                        _t(hb)).numpy()
    assert got.dtype == np.int32 and got[0] == 0
    np.testing.assert_array_equal(got[1:], oracle[1:])
    np.testing.assert_array_equal(got, fused32)


def test_euler_tour_matches_reference():
    from repro.core.dbht import _euler_tour
    r = np.random.default_rng(2)
    parent = np.array([-1] + [int(r.integers(0, b)) for b in range(1, 300)])
    tin, tout = tfa.euler_tour(parent)
    want_in, want_out = _euler_tour(parent)
    np.testing.assert_array_equal(tin, want_in)
    np.testing.assert_array_equal(tout, want_out)


def test_fused_caps_match_reference(monkeypatch):
    for n in (5, 120, 256, 2000, 19412):
        assert tfa.fused_caps(n) == jfa.fused_caps(n)
    for mod in (tfa, jfa):
        monkeypatch.setattr(mod, "FUSED_C_CAP", 8)
        monkeypatch.setattr(mod, "FUSED_M_CAP", 16)
    for n in (5, 120, 256, 2000):
        assert tfa.fused_caps(n) == jfa.fused_caps(n)
    cfg = tcore.PipelineConfig.approx()
    assert not tfa.use_sparse_tail(cfg, 199) and tfa.use_sparse_tail(cfg, 200)


# ---------------------------------------------------------------------------
# the whole approx pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[120, 256])
def approx_data(request):
    n = request.param
    X, _ = make_dataset(n, 46, 5, noise=0.6, seed=n)
    return n, X, np.asarray(jpearson(jnp.asarray(X)))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("src", ["S", "X"])
def test_cluster_approx_matches_reference(approx_data, fused, src):
    n, X, S = approx_data
    kw = dict(S=S) if src == "S" else dict(X=X)
    want = jcore.cluster(**kw, k=5, fused=fused, collect_timings=True,
                         config=jcore.PipelineConfig.approx(sim_k=32))
    got = tcore.cluster(**kw, k=5, fused=fused, collect_timings=True,
                        config=tcore.PipelineConfig.approx(sim_k=32),
                        device="cpu")
    Zw = np.asarray(want.linkage)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.linkage[:, [0, 1, 3]], Zw[:, [0, 1, 3]])
    if src == "S":
        np.testing.assert_array_equal(got.linkage, Zw)
    else:
        np.testing.assert_allclose(got.linkage[:, 2], Zw[:, 2], rtol=0,
                                   atol=1e-4)
    for key in ("sim_fallbacks", "sim_fallback_rate", "sim_pair_misses"):
        assert got.timings[key] == want.timings[key], key
    assert (got.dbht.hubs is not None) == (fused and n >= 200)
    if not fused:
        assert set(got.timings) >= {"similarity", "tmfg", "apsp", "dbht",
                                    "hac", "total"}


def test_fused_overflow_reruns_staged(monkeypatch):
    """A fused run whose coarse clusters overflow the slot caps stops
    before the composed-distance sweep and reruns the staged path."""
    X, _ = make_dataset(256, 46, 5, noise=0.6, seed=7)
    cfg = tcore.PipelineConfig.approx(sim_k=32)
    want = tcore.cluster(X=X, k=5, fused=False, config=cfg, device="cpu")
    monkeypatch.setattr(tfa, "FUSED_M_CAP", 2)

    def no_sweep(*args, **kwargs):
        raise AssertionError("composed-distance sweep after an overflow")

    monkeypatch.setattr(tfa, "_sweep_panels", no_sweep)
    got = tcore.cluster(X=X, k=5, config=cfg, device="cpu",
                        collect_timings=True)
    np.testing.assert_array_equal(got.linkage, want.linkage)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.dbht.hubs is None
    assert set(got.timings) >= {"similarity", "tmfg", "apsp", "dbht", "hac",
                                "total", "sim_fallbacks"}
