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
from repro_torch.data.graphs import apollonian_edges  # noqa: E402
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


@pytest.mark.parametrize("n", [24, 64])
def test_sources_minor_loop_matches_jax_fixed_point(n):
    """The Bellman-Ford loop on the sources-minor layout Dt (n, sp), the
    plain round on Dt's transpose with +inf padding sources, reaches the
    JAX sparse_apsp_sources fixed point and round count bitwise, and its
    padding stays +inf."""
    jg, _, _, _ = _jax_csr(n)
    g = interop.csr_from_numpy(jg, "cpu")
    src = np.array([0, 3, n // 2, n - 1, 7], np.int32)
    s = src.shape[0]
    want = np.asarray(jsp.sparse_apsp_sources(jg, jnp.asarray(src)))
    Dt = tsp.to_sources_minor(torch.from_numpy(
        np.where(np.arange(n)[None, :] == src[:, None], 0.0,
                 np.inf).astype(np.float32)))
    assert Dt.shape == (n, 32)
    rounds, changed = 0, True
    while changed:
        Dt, flag = ops.sparse_relax_t(Dt, s, g, backend="torch")
        changed = bool(flag)
        rounds += 1
    np.testing.assert_array_equal(tsp.from_sources_minor(Dt, s).numpy(),
                                  want)
    assert bool(torch.isinf(Dt[:, s:]).all())
    stats = {}
    got = tsp.sparse_apsp_sources(g, _t(src), stats=stats)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats["bf_rounds"] == rounds >= 3
    # the JAX loop stops after the same round: its state after rounds - 1
    # rounds is the fixed point (the last round changed nothing), its
    # state after rounds - 2 is not; the port's capped loops agree
    for cap, fixed in ((rounds - 1, True), (rounds - 2, False)):
        jd = np.asarray(jsp.sparse_apsp_sources(jg, jnp.asarray(src),
                                                rounds=cap))
        assert np.array_equal(jd, want) == fixed
        np.testing.assert_array_equal(
            tsp.sparse_apsp_sources(g, _t(src), rounds=cap).numpy(), jd)


def _star_path(n, hub_degree):
    """A path over n vertices plus a hub (vertex 0) joined to the first
    hub_degree others: rows longer than one work item."""
    e = {(i, i + 1) for i in range(n - 1)}
    e |= {(0, j) for j in range(2, hub_degree + 1)}
    return np.array(sorted(e), np.int32)


@pytest.mark.parametrize("n,hub", [(80, 70), (40, 3), (200, 150)])
def test_relax_plan_items_cover_each_row(n, hub):
    """The kernel's work items: each row cut, in order, into runs of at
    most ITEM entries; a row of several runs gets consecutive partial
    slots that name its first slot and count; folding every item's
    minimum and D is the plain round, bitwise, NaN included."""
    edges = _star_path(n, hub)
    rng = np.random.default_rng(n)
    w = rng.uniform(0.1, 2.0, edges.shape[0]).astype(np.float32)
    w[3] = np.nan
    g = tsp.csr_from_edges(n, _t(edges), _t(w))
    plan = tsp.relax_plan(g.indptr)
    items = plan.items.long()
    indptr = g.indptr.long()
    deg = indptr[1:] - indptr[:-1]
    assert items.shape[0] == int(torch.clamp((deg + 31) // 32, min=1).sum())
    assert bool(((items[:, 2] - items[:, 1]) <= tsp.ITEM).all())
    for v in range(n):
        mine = items[items[:, 0] == v]
        assert int(mine[0, 1]) == int(indptr[v])
        assert int(mine[-1, 2]) == int(indptr[v + 1])
        assert torch.equal(mine[1:, 1], mine[:-1, 2])
        if mine.shape[0] == 1:
            assert int(mine[0, 3]) == -1
        else:
            sl = mine[:, 3]
            assert torch.equal(sl, sl[0] + torch.arange(mine.shape[0]))
            assert bool((plan.slots[sl].long() == torch.tensor(
                [int(sl[0]), mine.shape[0]])).all())
    assert plan.n_slots == int((items[:, 3] >= 0).sum())
    assert (plan.n_slots > 0) == (hub > tsp.ITEM)
    assert not bool(plan.counters.any())
    s = 5
    D = rng.uniform(0, 4, (s, n)).astype(np.float32)
    D[rng.random(D.shape) < 0.4] = np.inf
    D[1, 5] = np.nan
    Dt = tsp.to_sources_minor(_t(D))
    out = Dt.clone()
    for v, e0, e1, _ in items.tolist():
        if e1 > e0:
            cand = (Dt[g.cols[e0:e1].long()] + g.vals[e0:e1, None]).amin(0)
            out[v] = torch.minimum(out[v], cand)
    want = ref.sparse_relax_ref(_t(D), g.indptr, g.cols, g.vals)
    got = tsp.from_sources_minor(out, s)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


@pytest.mark.parametrize("n", [4, 5, 64, 1000])
def test_apollonian_edges_shape_connected_deterministic(n):
    """3n - 6 distinct edges (lo < hi), every vertex reached from vertex
    0, planar counts, the same edges for the same seed and others for
    another seed."""
    e = apollonian_edges(n, seed=3)
    assert e.shape == (3 * n - 6, 2) and e.dtype == np.int32
    assert bool((e[:, 0] < e[:, 1]).all()) and e.min() == 0 and e.max() == n - 1
    assert len({tuple(r) for r in e.tolist()}) == 3 * n - 6
    adj = [[] for _ in range(n)]
    for a, b in e.tolist():
        adj[a].append(b)
        adj[b].append(a)
    seen, todo = {0}, [0]
    while todo:
        for u in adj[todo.pop()]:
            if u not in seen:
                seen.add(u)
                todo.append(u)
    assert len(seen) == n
    assert min(len(a) for a in adj) >= 3
    np.testing.assert_array_equal(e, apollonian_edges(n, seed=3))
    if n > 5:
        assert not np.array_equal(e, apollonian_edges(n, seed=4))
    with pytest.raises(ValueError):
        apollonian_edges(3)


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
