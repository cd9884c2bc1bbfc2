"""The port's APSP and HAC (``repro_torch.core.apsp``/``hac``) against JAX.

Each stage is fed the reference's own intermediate — the JAX TMFG and S
for the edge lengths, the JAX W for APSP, the JAX D for the linkage — so
a difference in one stage cannot hide in the next.  Every comparison is
bitwise: edge lengths are one correctly rounded sqrt per edge, min-plus
is a minimum of exactly rounded sums, and the linkage compares the same
values with the same lowest-index tie-break in both of its forms.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import clustered_similarity, random_symmetric  # noqa: E402
from repro.core import apsp as japsp  # noqa: E402
from repro.core import hac as jhac  # noqa: E402
from repro.core import tmfg as jtmfg  # noqa: E402
from repro_torch.core import apsp as tapsp  # noqa: E402
from repro_torch.core import hac as thac  # noqa: E402


def _graph(n, seed=0):
    """JAX S (f32), TMFG and W at n vertices."""
    S, _, _ = clustered_similarity(n, k=4, seed=seed)
    S = S.astype(np.float32)
    tm = jtmfg.build_tmfg(jnp.asarray(S), topk=64)
    W = japsp.edge_lengths(n, tm.edges, jnp.asarray(S))
    return S, tm, np.asarray(W)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n", [24, 48])
def test_edge_lengths_bitwise(n):
    S, tm, W = _graph(n, seed=n)
    got = tapsp.edge_lengths(n, _t(tm.edges), _t(S)).numpy()
    np.testing.assert_array_equal(got, W)


@pytest.mark.parametrize("n", [24, 48])
def test_apsp_exact_bitwise(n):
    _, _, W = _graph(n, seed=n + 1)
    want = np.asarray(japsp.apsp_exact(jnp.asarray(W)))
    np.testing.assert_array_equal(tapsp.apsp_exact(_t(W)).numpy(), want)


@pytest.mark.parametrize("n_hubs", [0, 5])
@pytest.mark.parametrize("rounds", [0, 2])
def test_apsp_hub_bitwise(n_hubs, rounds):
    _, _, W = _graph(48, seed=7)
    want = np.asarray(japsp.apsp_hub(jnp.asarray(W), n_hubs=n_hubs,
                                     rounds=rounds))
    stats = {}
    got = tapsp.apsp_hub(_t(W), n_hubs=n_hubs, rounds=rounds, stats=stats)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 1 <= stats["bf_rounds"] <= (rounds or 48)


def test_apsp_dispatch():
    _, _, W = _graph(40, seed=8)
    exact = tapsp.apsp_exact(_t(W))
    assert torch.equal(tapsp.apsp(_t(W), method="hub"), exact)  # n < 200
    assert torch.equal(tapsp.apsp(_t(W), method="exact"), exact)
    assert torch.equal(tapsp.apsp(_t(W), method="sparse"),
                       tapsp.apsp_sparse(_t(W)))
    assert tapsp.HUB_MIN_N == japsp.HUB_MIN_N
    for n in (1, 9, 48, 19412):
        assert tapsp.hub_count(n) == japsp.hub_count(n)


def _distances(kind, n):
    if kind == "apsp":
        _, _, W = _graph(n, seed=n + 2)
        return np.array(japsp.apsp_exact(jnp.asarray(W)))
    r = np.random.default_rng(n)
    D = r.integers(1, 6, (n, n)).astype(np.float32)       # many ties
    D = np.minimum(D, D.T)
    np.fill_diagonal(D, 0.0)
    return D


@pytest.mark.parametrize("kind", ["apsp", "ties"])
@pytest.mark.parametrize("n", [5, 24, 48])
def test_complete_linkage_both_forms_bitwise(kind, n):
    D = _distances(kind, n)
    flat = np.asarray(jhac.complete_linkage(jnp.asarray(D), backend="jnp"))
    masked = np.asarray(jhac.complete_linkage(jnp.asarray(D),
                                              backend="auto"))
    np.testing.assert_array_equal(
        thac.complete_linkage(_t(D), backend="torch").numpy(), flat)
    np.testing.assert_array_equal(
        thac.complete_linkage(_t(D), backend="auto").numpy(), masked)


def test_hierarchical_offsets_bitwise():
    n = 30
    D = _distances("apsp", n)
    D[0, 5] = D[5, 0] = np.inf                           # a disconnected pair
    r = np.random.default_rng(1)
    bubble_of = r.integers(0, 6, n).astype(np.int32)
    cluster_of = (bubble_of // 2).astype(np.int32)
    want = np.asarray(jhac.hierarchical_offsets(
        jnp.asarray(D), jnp.asarray(bubble_of), jnp.asarray(cluster_of)))
    got = thac.hierarchical_offsets(_t(D), _t(bubble_of), _t(cluster_of))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 3, 7, 24])
def test_cut_linkage_equal(k):
    D = _distances("ties", 24)
    Z = np.asarray(jhac.complete_linkage(jnp.asarray(D)))
    np.testing.assert_array_equal(thac.cut_linkage(_t(Z), 24, k),
                                  jhac.cut_linkage(Z, 24, k))


def test_random_symmetric_linkage_bitwise():
    D = np.abs(random_symmetric(32, 9)).astype(np.float32)
    np.fill_diagonal(D, 0.0)
    want = np.asarray(jhac.complete_linkage(jnp.asarray(D), backend="jnp"))
    np.testing.assert_array_equal(
        thac.complete_linkage(_t(D), backend="auto").numpy(), want)
