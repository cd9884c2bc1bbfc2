"""The rest of the port's ``repro_torch.approx`` against ``repro.approx``,
on the CPU: sketches, candidate pools, pool rescoring and the
approx-against-dense harness.

  * ``sketch``: JAX's ``PRNGKey`` stream is not reproduced, so the tests
    carry the reference's projection R across in place of
    ``project.projection``'s; given it, the sketch is within 1e-6 of the
    reference's (the product rounds otherwise).
  * ``candidate_pools``: given JAX's own sketch, bitwise JAX's pools;
    seed-deterministic, free of self-candidates, and one seed's R is the
    same wherever it is used.
  * ``rescore_pools``: the table's (value desc, index asc) tie order on
    exact ties (the reference's test), JAX's table on JAX's pools
    (indices exact, values within 1e-6), a full pool reproducing
    ``topk_pearson``, and the row panels changing nothing.
  * ``compare_to_dense``: the reference's dict.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.approx as japprox  # noqa: E402
from repro.approx import knn as jknn  # noqa: E402
from repro.approx import project as jproject  # noqa: E402
from repro.data.timeseries import make_dataset  # noqa: E402
import repro_torch.approx as tapprox  # noqa: E402
from repro_torch import filters as tfilters  # noqa: E402
from repro_torch.approx import knn as tknn  # noqa: E402
from repro_torch.approx import project as tproject  # noqa: E402

from conftest import clustered_similarity  # noqa: E402


def _jax_R(L, dim, seed):
    """The reference's projection, as ``repro.approx.project.sketch``
    draws it."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (L, dim),
                                        jnp.float32) / jnp.sqrt(float(dim)))


@pytest.fixture
def jax_R(monkeypatch):
    monkeypatch.setattr(tproject, "projection",
                        lambda L, dim, seed: torch.tensor(
                            _jax_R(L, dim, seed)))


def _series(n, L=40, seed=7):
    return clustered_similarity(n, k=3, L=L, seed=seed)[1].astype(np.float32)


@pytest.mark.parametrize("n,L,dim,seed", [(60, 64, 32, 3), (40, 46, 16, 0)])
def test_sketch_within_1e6_given_reference_R(jax_R, n, L, dim, seed):
    X = _series(n, L)
    got = tproject.sketch(torch.from_numpy(X), dim=dim, seed=seed)
    want = np.asarray(jproject.sketch(jnp.asarray(X), dim=dim, seed=seed))
    assert got.shape == (n, dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,pool,dim", [(60, 16, 32), (60, 59, 32),
                                        (48, 8, 16)])
def test_candidate_pools_bitwise_given_reference_sketch(monkeypatch, n, pool,
                                                        dim):
    X = _series(n)
    want = np.asarray(jproject.candidate_pools(X, pool, dim=dim, seed=3))
    sk = np.asarray(jproject.sketch(jnp.asarray(X), dim=dim, seed=3))
    monkeypatch.setattr(tproject, "sketch",
                        lambda X_, dim, seed: torch.from_numpy(sk))
    got = tproject.candidate_pools(torch.from_numpy(X), pool, dim=dim,
                                   seed=3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


def test_candidate_pools_seeded_and_self_free():
    n = 60
    X = torch.from_numpy(_series(n))
    p1 = tproject.candidate_pools(X, 16, dim=32, seed=3)
    p2 = tproject.candidate_pools(X, 16, dim=32, seed=3)
    assert torch.equal(p1, p2)
    assert not (p1 == torch.arange(n)[:, None]).any()
    assert not torch.equal(p1, tproject.candidate_pools(X, 16, dim=32,
                                                        seed=4))
    assert tproject.candidate_pools(X, 500, dim=32).shape == (n, n - 1)
    R = tproject.projection(40, 32, 3)
    assert torch.equal(R, tproject.projection(40, 32, 3))
    assert R.shape == (40, 32) and R.device.type == "cpu"
    assert abs(float(R.std()) * 32 ** 0.5 - 1.0) < 0.1


def test_rescore_pools_tie_order_is_index_ascending():
    """The reference's test: duplicated rows and shuffled pools make exact
    ties, which must come out index ascending."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(7, 24)).astype(np.float32)
    X = np.concatenate([X, X], axis=0)
    n = X.shape[0]
    pools = np.stack([rng.permutation(np.delete(np.arange(n), i))
                      for i in range(n)])
    re = tknn.rescore_pools(X, pools, 6)
    v, i = re.values.numpy(), re.indices.numpy()
    assert (v[:, :-1] >= v[:, 1:]).all()
    ties = v[:, :-1] == v[:, 1:]
    assert ties.any()
    assert (i[:, :-1][ties] < i[:, 1:][ties]).all()


@pytest.mark.parametrize("n,pool,k", [(60, 24, 8), (48, 47, 12)])
def test_rescore_pools_matches_reference(n, pool, k):
    X = _series(n)
    pools = np.asarray(jproject.candidate_pools(X, pool, dim=32, seed=1))
    want = jknn.rescore_pools(X, pools, k)
    got = tknn.rescore_pools(torch.from_numpy(X), torch.from_numpy(pools), k)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               rtol=0, atol=1e-6)
    assert got.indices.dtype == torch.int32


def test_full_pool_rescoring_reproduces_topk_pearson():
    n = 60
    X = torch.from_numpy(_series(n))
    full = tproject.candidate_pools(X, n - 1, dim=32, seed=3)
    re = tknn.rescore_pools(X, full, 8)
    exact = tknn.topk_pearson(X, 8)
    assert torch.equal(re.indices, exact.indices)
    np.testing.assert_allclose(re.values.numpy(), exact.values.numpy(),
                               rtol=0, atol=1e-6)


def test_rescore_panels_change_nothing(monkeypatch):
    X = torch.from_numpy(_series(50))
    pools = tproject.candidate_pools(X, 20, dim=16, seed=2)
    whole = tknn.rescore_pools(X, pools, 10)
    monkeypatch.setattr(tknn, "_SORT_ELEMS", 20 * 40 * 3)   # 3-row panels
    panels = tknn.rescore_pools(X, pools, 10)
    assert torch.equal(whole.values, panels.values)
    assert torch.equal(whole.indices, panels.indices)


def test_compare_to_dense_matches_reference():
    X, _ = make_dataset(80, 40, 3, noise=0.7, seed=2)
    want = japprox.compare_to_dense(X, sim_k=16, k=3)
    got = tapprox.compare_to_dense(X, sim_k=16, k=3, device="cpu")
    assert set(got) == set(want)
    assert got == pytest.approx({k: float(v) for k, v in want.items()},
                                rel=1e-6)


def test_approx_exports_match_reference():
    public = {name for name in dir(japprox) if not name.startswith("_")}
    modules = {"knn", "project", "quality", "sparse_tmfg"}
    assert public - modules <= set(dir(tapprox))
    # the edge-set helpers are the filters' own, re-exported
    assert tapprox.quality.edge_set is tfilters.edge_set
    assert tapprox.edge_recall is tfilters.edge_recall
