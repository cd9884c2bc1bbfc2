"""The port's lazy TMFG construction (``repro_torch.core.tmfg``) against JAX.

(CORR, ORIG, the step count per sync and the numpy oracle:
tests/test_torch_tmfg_loop.py.)

Given the same float32 S, every ``TMFGResult`` field — the pop count
included — must equal the JAX construction's, dtype and bits, for the OPT
(top-64 table) and HEAP (full scans) lookups.  Inputs are the repo's
adversarial ``random_symmetric`` matrices and clustered ``make_dataset``
correlations, all from numpy seeds.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import random_symmetric  # noqa: E402
from repro.core import tmfg as jtmfg  # noqa: E402
from repro.data.timeseries import make_dataset  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import tmfg as ttmfg  # noqa: E402


def _similarity(kind, n, seed):
    if kind == "random":
        return random_symmetric(n, seed).astype(np.float32)
    X, _ = make_dataset(n, 40, 4, noise=0.8, seed=seed)
    return np.corrcoef(X).astype(np.float32)


def _assert_tmfg_equal(jres, tres):
    for f in jres._fields:
        want = np.asarray(getattr(jres, f))
        got = getattr(tres, f).cpu().numpy()
        assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("n", [4, 5, 24, 48])
@pytest.mark.parametrize("topk", [0, 64])
@pytest.mark.parametrize("kind", ["random", "clustered"])
def test_lazy_tmfg_equals_jax(n, topk, kind):
    S = _similarity(kind, n, seed=n + topk)
    jres = jtmfg.build_tmfg(jnp.asarray(S), method="lazy", topk=topk)
    tres = ttmfg.build_tmfg(torch.from_numpy(S), method="lazy", topk=topk)
    _assert_tmfg_equal(jres, tres)


def test_host_syncs_are_pops_plus_two():
    """The lazy loop no longer syncs once per pop (``pops + 2``): it reads
    the inserted count once per T steps and downloads the edge values
    and counters once, ``ceil(pops / T) + 1`` syncs on the CPU, at most
    ``ceil(pops / T) + 3`` anywhere."""
    S = torch.from_numpy(_similarity("clustered", 40, 1))
    res, syncs = ttmfg._build(ttmfg.prepare_similarity(S), "lazy", topk=64)
    T = ttmfg.STEPS_PER_SYNC
    assert syncs == math.ceil(int(res.pops) / T) + 1
    assert syncs <= math.ceil(int(res.pops) / T) + 3 < int(res.pops) + 2


def test_build_does_not_change_the_input():
    S = torch.from_numpy(_similarity("random", 24, 2))
    before = S.clone()
    ttmfg.build_tmfg(S, topk=64)
    assert torch.equal(S, before)


def test_candidate_table_matches_lax_top_k_with_ties():
    """Stable descending sort == ``lax.top_k`` order (value desc, index
    asc), ties and the -inf diagonal included."""
    r = np.random.default_rng(3)
    S = r.integers(0, 5, (30, 30)).astype(np.float32)
    np.fill_diagonal(S, -np.inf)
    got = ttmfg.candidate_table(torch.from_numpy(S), 12).numpy()
    want = np.asarray(jax.lax.top_k(jnp.asarray(S), 12)[1])
    np.testing.assert_array_equal(got, want)


def test_adjacency_helpers_equal_jax():
    S = _similarity("clustered", 24, 4)
    jres = jtmfg.build_tmfg(jnp.asarray(S), topk=64)
    edges = torch.from_numpy(np.array(jres.edges))
    np.testing.assert_array_equal(
        ttmfg.tmfg_adjacency(24, edges, torch.from_numpy(S)).numpy(),
        np.asarray(jtmfg.tmfg_adjacency(24, jres.edges, jnp.asarray(S))))
    w = np.random.default_rng(5).normal(size=edges.shape[0]).astype(np.float32)
    np.testing.assert_array_equal(
        ttmfg.adjacency_from_weights(24, edges, torch.from_numpy(w)).numpy(),
        np.asarray(jtmfg.adjacency_from_weights(24, jres.edges,
                                                jnp.asarray(w))))


def test_interop_carries_a_jax_result_over():
    S = _similarity("random", 24, 6)
    jres = jtmfg.build_tmfg(jnp.asarray(S), topk=64)
    _assert_tmfg_equal(jres, interop.tmfg_from_numpy(jres, "cpu"))


def test_clique_row_sums_within_ulps_of_jax():
    """The clique is the top 4 finite row sums.  XLA and PyTorch sum a
    long row in different orders, so the sums may differ in the last
    bits (ROADMAP Queue 3); the clique can only differ where two sums
    sit that close.  Pin the size of the gap, in ulps of sum(|S_ij|),
    the scale of a float32 summation error."""
    for seed in range(4):
        S = _similarity("clustered", 64, seed)
        np.fill_diagonal(S, -np.inf)
        want = np.asarray(jnp.where(jnp.isfinite(S), S, 0.0).sum(axis=1))
        t = torch.from_numpy(S)
        got = torch.where(torch.isfinite(t), t, 0.0).sum(dim=1).numpy()
        scale = np.abs(np.where(np.isfinite(S), S, 0.0)).sum(axis=1)
        assert np.all(np.abs(got - want)
                      <= 4 * np.spacing(scale.astype(np.float32)))
