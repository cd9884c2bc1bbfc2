"""The port's sparse APSP (``repro_torch.kernels.sparse_apsp`` and
``core/apsp.py``'s sparse hub factor) against the JAX package.

Every comparison is bitwise: the CSR is a stable sort of the same
entries, the hub strength a left-to-right sum per row in both packages,
and a relaxation round a minimum of exactly rounded sums, so neither
the round nor the fixed point depends on the order.  Inputs are JAX
TMFGs of clustered similarities and random graphs from numpy seeds;
each stage gets the reference's own intermediate (``interop``).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import clustered_similarity  # noqa: E402
from repro.core import apsp as japsp  # noqa: E402
from repro.core import tmfg as jtmfg  # noqa: E402
from repro.kernels import sparse_apsp as jsp  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import apsp as tapsp  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import sparse_apsp as tsp  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _graph(n):
    """JAX TMFG edges, edge lengths and W at n vertices."""
    S, _, _ = clustered_similarity(n, k=4, seed=n)
    S = jnp.asarray(S.astype(np.float32))
    tm = jtmfg.build_tmfg(S, topk=64)
    W = japsp.edge_lengths(n, tm.edges, S)
    w = W[tm.edges[:, 0], tm.edges[:, 1]]
    return tm.edges, w, W


def _jax_csr(n):
    edges, w, W = _graph(n)
    return jsp.csr_from_edges(n, edges, w), edges, w, W


def _assert_csr_equal(jg, tg):
    for f in jg._fields:
        want = np.asarray(getattr(jg, f))
        got = getattr(tg, f).numpy()
        assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("n", [24, 64])
def test_csr_from_edges_bitwise(n):
    jg, edges, w, _ = _jax_csr(n)
    tg = tsp.csr_from_edges(n, _t(edges), _t(w))
    _assert_csr_equal(jg, tg)
    assert tg.n == jg.n == n
    _assert_csr_equal(jg, interop.csr_from_numpy(jg, "cpu"))


def test_csr_from_edges_keeps_duplicates_in_input_order():
    """A stable (row, col) sort, as the reference's lexsort."""
    edges = np.array([[0, 2], [1, 2], [0, 2], [2, 3]], np.int32)
    w = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    jg = jsp.csr_from_edges(4, jnp.asarray(edges), jnp.asarray(w))
    _assert_csr_equal(jg, tsp.csr_from_edges(4, _t(edges), _t(w)))


def test_csr_from_dense_bitwise():
    _, _, W = _graph(64)
    jg = japsp.csr_from_dense(W)
    _assert_csr_equal(jg, tapsp.csr_from_dense(_t(W)))


@pytest.mark.parametrize("n", [24, 64])
def test_hub_strength_bitwise(n):
    jg, _, _, _ = _jax_csr(n)
    got = tsp.hub_strength(interop.csr_from_numpy(jg, "cpu")).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsp.hub_strength(jg)))


@pytest.mark.parametrize("s,be", [(3, 4096), (17, 64)])
def test_gather_add_ref_matches_pallas(s, be):
    jg, _, _, _ = _jax_csr(64)
    rng = np.random.default_rng(s)
    D = rng.uniform(0, 4, (s, 64)).astype(np.float32)
    D[rng.random(D.shape) < 0.3] = np.inf
    want = jsp.gather_add_pallas(jnp.asarray(D), jg.cols, jg.vals, bs=8,
                                 be=be, interpret=True)
    got = ref.gather_add_ref(_t(D), _t(jg.cols), _t(jg.vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", ["jnp", "interpret"])
@pytest.mark.parametrize("n", [24, 64])
def test_sparse_relax_round_bitwise(backend, n):
    jg, _, _, _ = _jax_csr(n)
    tg = interop.csr_from_numpy(jg, "cpu")
    rng = np.random.default_rng(n)
    D = rng.uniform(0, 4, (7, n)).astype(np.float32)
    D[rng.random(D.shape) < 0.5] = np.inf
    want = np.asarray(jsp.sparse_relax(jnp.asarray(D), jg, backend=backend))
    got = ref.sparse_relax_ref(_t(D), tg.indptr, tg.cols, tg.vals)
    np.testing.assert_array_equal(got.numpy(), want)
    out, changed = ops.sparse_relax(_t(D), tg)
    assert torch.equal(out, got)
    assert bool(changed) == bool((got < _t(D)).any())
    np.testing.assert_array_equal(
        tsp.sparse_relax(_t(D), tg).numpy(), want)


def test_sparse_relax_ref_propagates_nan_and_keeps_empty_rows():
    """NaN in D or a weight reaches every output it is summed into (as
    torch.minimum and the segmented minimum propagate it); a vertex with
    no entries keeps its distance."""
    edges = torch.tensor([[0, 1], [1, 2]], dtype=torch.int32)
    g = tsp.csr_from_edges(4, edges, torch.tensor([1.0, float("nan")]))
    D = torch.tensor([[0.0, 5.0, 9.0, 2.0], [float("nan"), 1.0, 1.0, 3.0]])
    got = ref.sparse_relax_ref(D, g.indptr, g.cols, g.vals)
    # vertex 1's entry to 2 has a NaN weight, so row 0 gets NaN at 1 and 2
    want = torch.tensor([[0.0, float("nan"), float("nan"), 2.0],
                         [float("nan"), float("nan"), float("nan"), 3.0]])
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


@pytest.mark.parametrize("rounds", [0, 2])
@pytest.mark.parametrize("n", [24, 64])
def test_sparse_apsp_sources_bitwise(rounds, n):
    jg, _, _, _ = _jax_csr(n)
    src = np.array([0, 5, n // 2, n - 1], np.int32)
    want = np.asarray(jsp.sparse_apsp_sources(jg, jnp.asarray(src),
                                              rounds=rounds))
    stats = {}
    got = tsp.sparse_apsp_sources(interop.csr_from_numpy(jg, "cpu"),
                                  _t(src), rounds=rounds, stats=stats)
    np.testing.assert_array_equal(got.numpy(), want)
    if rounds:
        assert stats["bf_rounds"] == rounds
    else:
        assert 1 <= stats["bf_rounds"] <= n and np.isfinite(want).all()


@pytest.mark.parametrize("n_hubs", [0, 5])
@pytest.mark.parametrize("rounds", [0, 2])
def test_hub_factor_sparse_bitwise(n_hubs, rounds):
    jg, _, _, _ = _jax_csr(64)
    jh, jD = japsp.hub_factor_sparse(jg, n_hubs=n_hubs, rounds=rounds)
    stats = {}
    th, tD = tapsp.hub_factor_sparse(interop.csr_from_numpy(jg, "cpu"),
                                     n_hubs=n_hubs, rounds=rounds,
                                     stats=stats)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tD.numpy(), np.asarray(jD))
    assert stats["bf_rounds"] >= 1


def test_apsp_sparse_equals_reference_and_dense_hub():
    """The densified sparse factor equals the reference's, and equals the
    dense hub APSP: both relax the same graph to the same fixed point."""
    _, _, W = _graph(64)
    got = tapsp.apsp_sparse(_t(W)).numpy()
    np.testing.assert_array_equal(got, np.asarray(japsp.apsp_sparse(W)))
    np.testing.assert_array_equal(got, tapsp.apsp_hub(_t(W)).numpy())
