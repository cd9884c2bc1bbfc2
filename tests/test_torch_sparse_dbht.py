"""The port's sparse DBHT tail (``repro_torch.core.sparse_dbht``) and host
DBHT oracle (``dbht._dbht_host``) against the JAX package.

Stage by stage: both packages get the same S, the same TMFG (built by
the JAX package, or, for the host oracle's paper variants, by the port's
builders, which are bitwise JAX's: tests/test_torch_tmfg_loop.py) and,
where given, the same edge weights.  Every output is compared bitwise:
labels, converging set, directions, coarse and fine assignments, hubs,
the hub factor D_h and the linkage.  The two packages compute each of
them with the same float operations in the same order (the float64
direction sums as one ``np.bincount`` fold, the hub factor as a fixed
point of exactly rounded sums, minima over hubs, the 4-vertex means in
one association), so nothing here needs a tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from conftest import clustered_similarity, tmfg_f32  # noqa: E402
from repro.core import apsp as japsp  # noqa: E402
from repro.core import dbht as jdbht  # noqa: E402
from repro.core import sparse_dbht as jsd  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import apsp as tapsp  # noqa: E402
from repro_torch.core import dbht as tdbht  # noqa: E402
from repro_torch.core import sparse_dbht as tsd  # noqa: E402
from repro_torch.core.config import VARIANTS  # noqa: E402

FIELDS = ("linkage", "cluster_of", "bubble_of", "converging", "direction")


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_same(got, want, fields=FIELDS, msg=""):
    for f in fields:
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      _np(getattr(want, f)),
                                      err_msg=f"{msg} {f}")


def _S(n, seed=5):
    k = 2 if n < 8 else 4
    S, _, _ = clustered_similarity(n, k=k, L=24 if n < 8 else 64, seed=seed)
    return S.astype(np.float32)


class _HostTMFG:
    """A TMFG of numpy arrays: what the JAX package's host walk reads."""

    def __init__(self, ttm):
        for f in ttm._fields:
            setattr(self, f, getattr(ttm, f).numpy())


# ---------------------------------------------------------------------------
# (b) the host oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 5, 24, 64])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_host_oracle_matches_reference_and_device(variant, n):
    """``_dbht_host`` on every variant's TMFG: bitwise JAX's host walk,
    and bitwise the port's own device DBHT (the §11.4 contract)."""
    v = VARIANTS[variant]
    S = _S(n, seed=n)
    St = torch.from_numpy(S)
    ttm = tcore.build_tmfg(St, method=v["method"], prefix=v.get("prefix", 10),
                           topk=v["topk"], backend="torch")
    cfg = tcore.PipelineConfig.variant(variant)
    want = jdbht._dbht_host(S, _HostTMFG(ttm), apsp_method=v["apsp_method"],
                            apsp_backend="jnp", precomputed_apsp=None)
    got = tdbht._dbht_host(St, ttm, apsp_method=v["apsp_method"],
                           apsp_backend="auto")
    _assert_same(got, want, FIELDS + ("apsp",), msg=variant)
    dev = tdbht.dbht(St, ttm, config=cfg)
    _assert_same(dev, got, msg=variant)
    assert torch.equal(dev.apsp, got.apsp)
    np.testing.assert_array_equal(
        tdbht.dbht(St, ttm, config=cfg, impl="host").linkage.numpy(),
        got.linkage.numpy())


def test_host_oracle_pieces_match_reference():
    """The numpy pieces copied from the reference: the Euler tour (the
    port's two loops against the reference's DFS), the float64 edge
    directions and the flow walk."""
    S = _S(64, seed=3)
    tm = tmfg_f32(S, topk=64)
    h = {f: np.asarray(getattr(tm, f)) for f in tm._fields}
    r = np.random.default_rng(2)
    parent = np.array([-1] + [int(r.integers(0, b)) for b in range(1, 300)])
    for p in (parent, h["bubble_parent"]):
        for got, want in zip(tdbht.euler_tour(p), jdbht._euler_tour(p)):
            np.testing.assert_array_equal(got, want)
    args = (S.astype(np.float64), h["edges"], h["bubble_parent"],
            h["bubble_tri"], h["home_bubble"])
    for got, want in zip(tdbht._edge_directions(*args),
                         jdbht._edge_directions(*args)):
        np.testing.assert_array_equal(got, want)
    d = jdbht._edge_directions(*args)[0]
    for got, want in zip(tdbht._flow_to_converging(h["bubble_parent"], d),
                         jdbht._flow_to_converging(h["bubble_parent"], d)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# (c) the staged sparse tail
# ---------------------------------------------------------------------------

def _sparse_case(n, method="lazy", prefix=10, topk=64, seed=None):
    S = _S(n, seed=n if seed is None else seed)
    tm = tmfg_f32(S, method=method, prefix=prefix, topk=topk)
    return S, tm, interop.tmfg_from_numpy(tm, "cpu")


def _check_sparse(S, tm, ttm, msg, **kw):
    want = jsd.dbht_sparse(S, tm, **kw)
    got = tsd.dbht_sparse(torch.from_numpy(S), ttm, **kw)
    _assert_same(got, want, FIELDS + ("apsp", "hubs"), msg=msg)
    return got


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dbht_sparse_matches_reference_every_variant(variant):
    """Every variant's TMFG at n = 64: the device tail and the host
    oracle on the densified factor, each bitwise JAX's, and the two
    equal (the §14.5 contract)."""
    v = VARIANTS[variant]
    S, tm, ttm = _sparse_case(64, v["method"], v.get("prefix", 10),
                              v["topk"], seed=5)
    got = _check_sparse(S, tm, ttm, variant)
    host = _check_sparse(S, tm, ttm, variant, impl="host")
    _assert_same(host, got, msg=variant)
    assert tuple(got.apsp.shape) == (tapsp.hub_count(64), 64)
    assert tuple(host.apsp.shape) == (64, 64)


@pytest.mark.parametrize("n", [4, 5, 6, 300])
def test_dbht_sparse_matches_reference_by_size(n):
    """The degenerate sizes (one, two and three bubbles) and n = 300
    (many clusters, each block its own size)."""
    S, tm, ttm = _sparse_case(n)
    got = _check_sparse(S, tm, ttm, f"n={n}")
    assert got.linkage.shape == (n - 1, 4)
    if n < 300:
        _assert_same(_check_sparse(S, tm, ttm, f"n={n}", impl="host"), got)


def test_dbht_sparse_from_edge_weights_only():
    """The no-S entry: the similarity of each TMFG edge in place of S
    gives the from-S result, and the reference's, bitwise; the oracle
    then runs on the edge-weight adjacency."""
    S, tm, ttm = _sparse_case(64, seed=9)
    e = np.asarray(tm.edges)
    w = S[e[:, 0], e[:, 1]]
    want = jsd.dbht_sparse(None, tm, edge_weights=w)
    got = tsd.dbht_sparse(None, ttm, edge_weights=torch.from_numpy(w))
    _assert_same(got, want, FIELDS + ("apsp", "hubs"))
    _assert_same(got, tsd.dbht_sparse(torch.from_numpy(S), ttm))
    _assert_same(tsd.dbht_sparse(None, ttm, edge_weights=w, impl="host"),
                 jsd.dbht_sparse(None, tm, edge_weights=w, impl="host"))
    with pytest.raises(ValueError, match="edge_weights"):
        tsd.dbht_sparse(None, ttm)
    with pytest.raises(ValueError, match="impl"):
        tsd.dbht_sparse(torch.from_numpy(S), ttm, impl="gpu")


@pytest.mark.parametrize("hac_max", [1, 8])
def test_dbht_sparse_tree_mode_matches_reference(hac_max):
    """Clusters above ``hac_max`` take the bubble-tree linkage: bitwise
    the reference's, a full dendrogram (every id merged once, the root
    holds all), and the same flat partition as the exact mode."""
    n = 64
    S, tm, ttm = _sparse_case(n, seed=6)
    got = _check_sparse(S, tm, ttm, "tree", hac_max=hac_max)
    Z = got.linkage.numpy()
    refs = np.concatenate([Z[:, 0], Z[:, 1]]).astype(np.int64)
    assert sorted(refs.tolist()) == list(range(2 * n - 2))
    assert Z[-1, 3] == n and np.isfinite(Z).all()
    exact = tsd.dbht_sparse(torch.from_numpy(S), ttm)
    counts = np.bincount(exact.cluster_of.numpy())
    assert counts.max() > hac_max           # the tree mode really ran
    _assert_same(got, exact, ("cluster_of", "bubble_of"))


def test_densify_and_dispatch_through_dbht():
    """``dbht(apsp_method="sparse")`` routes to the tail, S or
    ``edge_weights``; ``densify`` is the dense form of the factor."""
    S, tm, ttm = _sparse_case(64, seed=11)
    St = torch.from_numpy(S)
    got = tdbht.dbht(St, ttm, apsp_method="sparse")
    _assert_same(got, jdbht.dbht(S, tm, apsp_method="sparse"))
    _assert_same(got, tsd.dbht_sparse(St, ttm), FIELDS + ("apsp", "hubs"))
    e = ttm.edges.long()
    w = St[e[:, 0], e[:, 1]]
    cfg = tcore.PipelineConfig(apsp_method="sparse")
    _assert_same(tdbht.dbht(None, ttm, config=cfg, edge_weights=w), got)
    W = tapsp.edge_lengths(64, ttm.edges, St)
    graph = tapsp.csr_from_dense(W)
    _, D_h = tapsp.hub_factor_sparse(graph)
    np.testing.assert_array_equal(tsd.densify(D_h, graph).numpy(),
                                  tapsp.apsp_sparse(W).numpy())


# ---------------------------------------------------------------------------
# (d) apsp(method="sparse")
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [24, 64])
def test_apsp_sparse_method_matches_reference_and_hub(n):
    S, tm, ttm = _sparse_case(n, seed=n + 1)
    W = japsp.edge_lengths(n, tm.edges, jnp.asarray(S))
    Wt = torch.from_numpy(np.array(W))
    got = tapsp.apsp(Wt, method="sparse")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(japsp.apsp(W, method="sparse")))
    np.testing.assert_array_equal(got.numpy(), tapsp.apsp_hub(Wt).numpy())


# ---------------------------------------------------------------------------
# (e) the fused sparse form against the staged one
# ---------------------------------------------------------------------------

_SPARSE_CONFIGS = {
    "opt": lambda m: m.PipelineConfig.opt().replace(apsp_method="sparse"),
    "par-10": lambda m: m.PipelineConfig.par(10).replace(
        apsp_method="sparse"),
    "approx": lambda m: m.PipelineConfig.approx(sim_k=24,
                                                apsp_method="sparse"),
    "approx-corr": lambda m: m.PipelineConfig.approx(
        sim_k=24, method="corr", topk=0, apsp_method="sparse"),
}


@pytest.mark.parametrize("config", sorted(_SPARSE_CONFIGS))
def test_fused_sparse_equals_staged_and_reference(config):
    """From one S, ``cluster``'s fused sparse body and the staged sparse
    tail give the same labels and linkage, and so does the JAX
    package's staged run (the port's fused directions are float64, so
    they agree with the staged oracle's on these graphs)."""
    S = _S(64, seed=12)
    make = _SPARSE_CONFIGS[config]
    fz = tcore.cluster(S=S, config=make(tcore), device="cpu")
    st = tcore.cluster(S=S, config=make(tcore), device="cpu", fused=False,
                       collect_timings=True)
    np.testing.assert_array_equal(fz.labels, st.labels)
    np.testing.assert_array_equal(fz.linkage, st.linkage)
    assert fz.dbht.hubs is not None and st.dbht.hubs is not None
    assert set(st.timings) >= {"similarity", "tmfg", "apsp", "dbht", "hac"}
    want = jcore.cluster(S=S, config=make(jcore), fused=False)
    np.testing.assert_array_equal(st.linkage, np.asarray(want.linkage))
    np.testing.assert_array_equal(st.labels, want.labels)
