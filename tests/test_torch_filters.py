"""The port's filter matrix (``repro_torch.filters``) against the JAX
package's ``repro.filters``, on the CPU.

  * MST, AG and PMFG edges and weights bitwise the reference's, order
    included (the MST's emission order, the AG's (value desc, position
    asc) order, the PMFG's sorted rows), ties included; ``edge_sum`` is a
    float32 sum in another association, so within 1e-6 relative.
  * RMT cleaning within 1e-5 of the reference's (``torch.linalg.eigh`` is
    not XLA's eigensolver), idempotent and trace-preserving.
  * ``filter_tail`` given JAX's S and FilterGraph: D, the components,
    ``cluster_of`` and Z bitwise for ``apsp_method`` exact, hub and
    sparse (n = 256 where the hub path needs n >= 200), a shattered AG
    included.
  * ``cluster`` and ``cluster_batch`` for mst and ag with and without
    RMT, and the TMFG with RMT: labels equal JAX's from X, the linkage
    bitwise JAX's given S (the non-RMT cases), fused bitwise staged, each
    batch entry bitwise ``cluster(X[b])``.
  * The reference's refusals, ``compare_filters``, and the repair of the
    fused approx routing (``_needs_approx_body``) for non-TMFG filters.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro import filters as jf  # noqa: E402
from repro.data.timeseries import make_dataset  # noqa: E402
from repro.kernels.ref import pearson_ref as jpearson  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch import filters as tf  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402

from conftest import random_symmetric  # noqa: E402


def _sym(n, seed):
    S = random_symmetric(n, seed)
    np.fill_diagonal(S, 1.0)
    return S.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_graph(got, want):
    np.testing.assert_array_equal(got.edges.numpy(), np.asarray(want.edges))
    np.testing.assert_array_equal(got.weights.numpy(),
                                  np.asarray(want.weights))
    assert got.edges.dtype == torch.int32
    assert got.weights.dtype == torch.float32
    assert float(got.edge_sum) == pytest.approx(float(want.edge_sum),
                                                rel=1e-6)


def _pearson(X):
    return np.asarray(jpearson(jnp.asarray(X)))


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,seed", [(8, 0), (23, 1), (64, 2)])
def test_mst_edges_bitwise_reference(n, seed):
    S = _sym(n, seed)
    stats = {}
    got = tf.build_mst(_t(S), stats=stats)
    _same_graph(got, jf.build_mst(jnp.asarray(S)))
    assert got.edges.shape == (n - 1, 2)
    assert 1 <= stats["mst_rounds"] <= int(np.ceil(np.log2(n)))


@pytest.mark.parametrize("n,seed", [(8, 0), (23, 1), (64, 2)])
def test_mst_total_weight_equals_networkx(n, seed):
    nx = pytest.importorskip("networkx")
    S = _sym(n, seed)
    fg = tf.build_mst(_t(S))
    G = nx.Graph()
    G.add_nodes_from(range(n))
    G.add_edges_from(map(tuple, fg.edges.numpy()))
    assert nx.is_tree(G)
    H = nx.Graph()
    for i in range(n):
        for j in range(i + 1, n):
            H.add_edge(i, j, weight=float(S[i, j]))
    ref = nx.maximum_spanning_tree(H)
    ref_w = sum(d["weight"] for _, _, d in ref.edges(data=True))
    assert float(fg.edge_sum) == pytest.approx(ref_w, rel=1e-5)


@pytest.mark.parametrize("kind", ["quantized", "all-equal"])
def test_mst_ties_bitwise_reference(kind):
    if kind == "quantized":
        S = np.round(_sym(40, 3) * 4) / 4          # many exact ties
    else:
        S = np.ones((17, 17), np.float32)
    got = tf.build_mst(_t(S.astype(np.float32)))
    _same_graph(got, jf.build_mst(jnp.asarray(S, jnp.float32)))


@pytest.mark.parametrize("n,m,quantize", [(32, 40, False), (64, 0, False),
                                          (40, 50, True), (17, 30, True)])
def test_ag_edges_bitwise_reference(n, m, quantize):
    S = _sym(n, n)
    if quantize:
        S = (np.round(S * 4) / 4).astype(np.float32)   # exact ties
    mm = tf.ag_edge_count(n, m)
    got = tf.build_ag(_t(S), m=mm)
    _same_graph(got, jf.build_ag(jnp.asarray(S), m=mm))
    assert got.edges.shape == (mm, 2)


def test_ag_edge_count_matches_reference():
    for n, m in ((50, 0), (50, 17), (4, 100), (2, 0), (3, 0), (300, 0)):
        assert tf.ag_edge_count(n, m) == jf.ag_edge_count(n, m)


@pytest.mark.parametrize("n,seed", [(12, 5), (24, 4), (30, 6)])
def test_pmfg_edges_bitwise_reference(n, seed):
    pytest.importorskip("networkx")
    S = _sym(n, seed)
    got = tf.build_pmfg(_t(S))
    _same_graph(got, jf.build_pmfg(jnp.asarray(S)))
    assert got.edges.shape == (3 * n - 6, 2)
    # the PMFG contains the MST (Tumminello 2005)
    assert tf.edge_set(tf.build_mst(_t(S)).edges) <= tf.edge_set(got.edges)


def test_filter_graph_adjacency_and_from_edges():
    S = _sym(20, 7)
    fg = tf.build_mst(_t(S))
    A = fg.adjacency(20)
    want = jf.build_mst(jnp.asarray(S)).adjacency(20)
    np.testing.assert_array_equal(A.numpy(), np.asarray(want))
    again = tf.from_edges(_t(S), fg.edges)
    assert torch.equal(again.edges, fg.edges)
    assert torch.equal(again.weights, fg.weights)


# ---------------------------------------------------------------------------
# RMT cleaning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,T", [(60, 40), (64, 24), (256, 46)])
def test_rmt_clean_within_1e5_of_reference(n, T):
    X, _ = make_dataset(n, T, 4, noise=0.7, seed=1)
    S = _pearson(X)
    got = tf.rmt.clean(_t(S), T)
    want = np.asarray(jf.rmt.clean(jnp.asarray(S), T))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert got.dtype == torch.float32


def test_rmt_idempotent_and_trace_preserving():
    n, T = 40, 60
    X, _ = make_dataset(n, T, 3, seed=9)
    C = torch.from_numpy(np.corrcoef(X).astype(np.float32))
    C1 = tf.rmt.clean(C, T)
    C2 = tf.rmt.clean(C1, T)
    np.testing.assert_allclose(C1.numpy(), C2.numpy(), atol=2e-5, rtol=0)
    assert float(torch.trace(C1)) == pytest.approx(float(torch.trace(C)),
                                                   rel=1e-5)
    assert torch.equal(C1, C1.T)


def test_rmt_bulk_edge_and_no_bulk_case():
    assert tf.rmt.bulk_edge(100, 400) == pytest.approx((1 + 0.5) ** 2)
    for n, T in ((100, 400), (60, 40), (7, 3)):
        assert tf.rmt.bulk_edge(n, T) == jf.rmt.bulk_edge(n, T)
    n, T = 12, 4000
    X, _ = make_dataset(n, T, 3, noise=0.2, seed=1)
    C = np.corrcoef(X).astype(np.float32)
    w = np.linalg.eigvalsh(C.astype(np.float64))
    keep = w[w >= tf.rmt.bulk_edge(n, T)]
    wc = np.linalg.eigvalsh(tf.rmt.clean(_t(C), T).numpy().astype(np.float64))
    np.testing.assert_allclose(np.sort(wc)[-len(keep):], np.sort(keep),
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the edge-list tail
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,method,filt,ag_m", [
    (40, "exact", "mst", 0), (40, "hub", "mst", 0),
    (256, "hub", "mst", 0), (256, "sparse", "mst", 0),
    (256, "sparse", "ag", 0), (60, "exact", "ag", 25),
    (256, "hub", "ag", 100)])
def test_filter_tail_bitwise_reference(n, method, filt, ag_m):
    X, _ = make_dataset(n, 46, 4, noise=0.7, seed=n)
    S = jnp.asarray(_pearson(X))
    fg = (jf.build_mst(S) if filt == "mst"
          else jf.build_ag(S, m=jf.ag_edge_count(n, ag_m)))
    want = jf.filter_tail(S, fg, apsp_method=method)
    stats = {}
    got = tf.filter_tail(_t(S), tf.FilterGraph(*(_t(f) for f in fg)),
                         apsp_method=method, stats=stats)
    for key in ("D", "conv_mask", "cluster_of", "bubble_of", "Z",
                "direction"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    comps = int(got["conv_mask"].sum())
    if ag_m:
        assert comps > 1                              # the AG shattered
        assert not np.isfinite(got["D"].numpy()).all()
    hub = method == "sparse" or (method == "hub" and n >= 200)
    assert ("bf_rounds" in stats) == hub


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

CONFIGS = {
    "mst": dict(filter="mst"),
    "ag": dict(filter="ag"),
    "mst-rmt": dict(filter="mst", clean="rmt"),
    "ag-rmt": dict(filter="ag", clean="rmt"),
    "tmfg-rmt": dict(clean="rmt"),
}


def _cfgs(name):
    return (jcore.PipelineConfig.opt(**CONFIGS[name]),
            tcore.PipelineConfig.opt(**CONFIGS[name]))


@pytest.fixture(scope="module")
def data():
    X, y = make_dataset(60, 40, 3, noise=0.7, seed=0)
    return X, y, _pearson(X)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cluster_from_X_matches_reference_and_fused_is_staged(data, name):
    X, _, _ = data
    jcfg, tcfg = _cfgs(name)
    want = jcore.cluster(X, k=3, config=jcfg)
    got = tcore.cluster(X, k=3, config=tcfg, device="cpu",
                        collect_timings=True)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.linkage[:, [0, 1, 3]],
                                  np.asarray(want.linkage)[:, [0, 1, 3]])
    np.testing.assert_allclose(got.linkage[:, 2],
                               np.asarray(want.linkage)[:, 2], atol=1e-4)
    staged = tcore.cluster(X, k=3, config=tcfg, device="cpu", fused=False,
                           collect_timings=True)
    np.testing.assert_array_equal(staged.linkage, got.linkage)
    np.testing.assert_array_equal(staged.labels, got.labels)
    assert staged.edge_sum == got.edge_sum
    stages = {"similarity", "tmfg", "apsp", "dbht", "hac"}
    if tcfg.clean == "rmt":
        stages.add("clean")
    assert stages <= set(staged.timings)
    if tcfg.filter != "tmfg":
        assert stages <= set(got.timings)             # fused: events/clock
        assert isinstance(got.tmfg, tf.FilterGraph)
        assert got.dbht.direction.numel() == 0


@pytest.mark.parametrize("name,apsp", [("mst", "hub"), ("ag", "hub"),
                                       ("mst", "sparse"), ("ag", "exact")])
def test_cluster_on_reference_S_is_bitwise(data, name, apsp):
    _, _, S = data
    jcfg, tcfg = _cfgs(name)
    want = jcore.cluster(S=S, k=3, config=jcfg.replace(apsp_method=apsp))
    got = tcore.cluster(S=S, k=3, config=tcfg.replace(apsp_method=apsp),
                        device="cpu")
    np.testing.assert_array_equal(got.linkage, np.asarray(want.linkage))
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.tmfg.edges.numpy(),
                                  np.asarray(want.tmfg.edges))
    assert got.edge_sum == pytest.approx(want.edge_sum, rel=1e-6)


@pytest.mark.parametrize("name", ["mst", "ag", "mst-rmt"])
def test_cluster_batch_entries_are_cluster(data, name):
    Xb = np.stack([make_dataset(48, 40, 3, noise=0.7, seed=s)[0]
                   for s in range(3)])
    jcfg, tcfg = _cfgs(name)
    want = jcore.cluster_batch(Xb, k=3, config=jcfg)
    for fused in (True, False):
        got = tcore.cluster_batch(Xb, k=3, config=tcfg, device="cpu",
                                  fused=fused)
        np.testing.assert_array_equal(got.labels, want.labels)
        for b in range(3):
            one = tcore.cluster(Xb[b], k=3, config=tcfg, device="cpu")
            np.testing.assert_array_equal(got[b].linkage, one.linkage)
            np.testing.assert_array_equal(got[b].labels, one.labels)


def test_cluster_batch_pmfg_runs_staged_on_S(data):
    pytest.importorskip("networkx")
    Sb = np.stack([_pearson(make_dataset(30, 40, 3, seed=s)[0])
                   for s in range(2)])
    cfg = tcore.PipelineConfig.opt().replace(filter="pmfg")
    want = jcore.cluster_batch(S=Sb, k=3, config=jcore.PipelineConfig.opt(
        ).replace(filter="pmfg"))
    got = tcore.cluster_batch(S=Sb, k=3, config=cfg, device="cpu",
                              limit=1)
    assert len(got) == 1
    np.testing.assert_array_equal(got[0].linkage,
                                  np.asarray(want[0].linkage))


def test_reference_refusals(data):
    X, _, S = data
    P = tcore.PipelineConfig
    pm = P.opt().replace(filter="pmfg")
    with pytest.raises(ValueError, match="fused=True requires"):
        tcore.cluster(X, config=pm, fused=True, device="cpu")
    with pytest.raises(ValueError, match="fused=True requires"):
        tcore.cluster_batch(X[None], config=pm, fused=True, device="cpu")
    for cfg in (P.mst(clean="rmt"), P.opt(clean="rmt")):
        with pytest.raises(ValueError, match="needs the raw series X"):
            tcore.cluster(S=S, config=cfg, device="cpu")
        with pytest.raises(ValueError, match="needs the raw series X"):
            tcore.cluster_batch(S=S[None], config=cfg, device="cpu")
    with pytest.raises(ValueError, match="non-TMFG filters"):
        tf.build_filter(_t(S), P.opt())
    tm = tcore.cluster(S=S, k=3, device="cpu").tmfg
    with pytest.raises(ValueError, match="rebuilds its graph"):
        tcore.cluster(S=S, config=P.mst(), reuse_tmfg=tm, device="cpu")
    with pytest.raises(ValueError, match="PMFG needs n >= 3"):
        tf.build_pmfg(torch.eye(2))


def test_mst_sparse_routes_to_the_edge_list_tail(data):
    """Repair: with filters allowed, ``filter="mst", apsp_method=
    "sparse"`` must run the filter tail, not the fused approx body."""
    P = tcore.PipelineConfig
    assert not tpipe._needs_approx_body(P.mst(apsp_method="sparse"))
    assert not tpipe._needs_approx_body(
        P.opt().replace(filter="ag", apsp_method="sparse"))
    assert tpipe._needs_approx_body(P.opt().replace(apsp_method="sparse"))
    assert tpipe._needs_approx_body(P.approx(sim_k=8))
    _, _, S = data
    got = tcore.cluster(S=S, k=3, config=P.mst(apsp_method="sparse"),
                        device="cpu")
    assert isinstance(got.tmfg, tf.FilterGraph) and got.dbht.hubs is None
    assert got.tmfg.edges.shape == (59, 2)


def test_compare_filters_rows_match_reference(data):
    pytest.importorskip("networkx")
    X, y, _ = data
    X, y = X[:30], y[:30]
    want = jf.compare_filters(X, y, k=3)
    got = tf.compare_filters(X, y, k=3, device="cpu")
    assert set(got) == set(want) == set(tf.FILTERS)
    for f in want:
        assert set(got[f]) == set(want[f])
        assert got[f] == pytest.approx(want[f], rel=1e-6), f


def test_package_exports_match_reference():
    assert set(jf.__all__) == set(tf.__all__)
    assert tf.FILTERS == jf.FILTERS
