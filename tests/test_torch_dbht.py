"""The port's device DBHT (``repro_torch.core.dbht``) against JAX.

Given JAX's S, TMFG and D (carried over with ``interop.tmfg_from_numpy``),
every output of the device core — directions, converging mask, coarse
clusters, fine bubbles, D and the linkage — must equal the reference's.
The side strengths behind the directions are long float32 sums whose
order differs between XLA and PyTorch (ROADMAP Queue 3): a direction
could only differ where the two sides are within a few ulps, and
``test_side_strength_margins`` pins that no tested edge is that close.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import clustered_similarity, random_symmetric  # noqa: E402
from repro.core import apsp as japsp  # noqa: E402
from repro.core import dbht as jdbht  # noqa: E402
from repro.core import tmfg as jtmfg  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import dbht as tdbht  # noqa: E402
from repro_torch.core.config import PipelineConfig  # noqa: E402

CASES = [("clustered", 24, 64, "exact"), ("clustered", 48, 64, "hub"),
         ("clustered", 64, 0, "exact"), ("random", 40, 64, "exact")]


def _inputs(kind, n, topk, apsp_method, seed=0):
    if kind == "random":
        S = random_symmetric(n, seed + n).astype(np.float32)
    else:
        S = clustered_similarity(n, k=4, seed=seed + n)[0].astype(np.float32)
    tm = jtmfg.build_tmfg(jnp.asarray(S), topk=topk)
    W = japsp.edge_lengths(n, tm.edges, jnp.asarray(S))
    if apsp_method == "hub":
        D = japsp.apsp_hub(W)              # forced hub program below 200
    else:
        D = japsp.apsp_exact(W)
    return S, tm, np.array(D)


def _core_args(tm):
    return (tm.edges, tm.bubble_parent, tm.bubble_tri, tm.bubble_verts,
            tm.home_bubble)


@pytest.mark.parametrize("kind,n,topk,apsp_method", CASES)
def test_device_core_equals_jax(kind, n, topk, apsp_method):
    S, tm, D = _inputs(kind, n, topk, apsp_method)
    want = jax.jit(jdbht._dbht_device_core)(jnp.asarray(S), *_core_args(tm),
                                            jnp.asarray(D))
    ttm = interop.tmfg_from_numpy(tm, "cpu")
    got = tdbht._dbht_device_core(torch.from_numpy(S), *_core_args(ttm),
                                  torch.from_numpy(D))
    for key in ("direction", "conv_mask", "cluster_of", "bubble_of", "D",
                "Z"):
        w = np.asarray(want[key])
        g = got[key].numpy()
        assert g.dtype == w.dtype, (key, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=key)


def test_anc_matrix_and_flow_equal_jax():
    rng = np.random.default_rng(0)
    for B in (1, 2, 7, 33):
        parent = np.full(B, -1, np.int32)
        for b in range(1, B):
            parent[b] = rng.integers(0, b)
        direction = np.concatenate(
            [[0], rng.choice([-1, 1], size=B - 1)]).astype(np.int32)
        np.testing.assert_array_equal(
            tdbht._anc_matrix(torch.from_numpy(parent)).numpy(),
            np.asarray(jdbht._anc_matrix(jnp.asarray(parent))))
        jn, jd, jc = jdbht._device_flow(jnp.asarray(parent),
                                        jnp.asarray(direction))
        tn, td, tc = tdbht._device_flow(torch.from_numpy(parent),
                                        torch.from_numpy(direction))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_side_strength_margins():
    """Where the two side strengths of an edge are within 4 ulps the
    direction could flip between XLA and PyTorch; no tested case has
    such an edge, so the bitwise comparisons above are not luck."""
    for kind, n, topk, apsp_method in CASES:
        S, tm, _ = _inputs(kind, n, topk, apsp_method)
        ttm = interop.tmfg_from_numpy(tm, "cpu")
        anc = tdbht._anc_matrix(ttm.bubble_parent)
        A = np.asarray(jtmfg.tmfg_adjacency(n, tm.edges, jnp.asarray(S)))
        tri = np.asarray(tm.bubble_tri)[1:]
        member = anc.numpy()[np.asarray(tm.home_bubble)].T[1:]
        rows = A[tri[:, 0]] + A[tri[:, 1]] + A[tri[:, 2]]
        rows[np.arange(len(tri))[:, None], tri] = 0.0
        s_child = np.where(member, rows, 0).astype(np.float64).sum(1)
        s_parent = np.where(member, 0, rows).astype(np.float64).sum(1)
        scale = np.abs(rows).astype(np.float64).sum(1)
        margin = np.abs(s_child - s_parent)
        assert np.all(margin > 4 * np.spacing(scale.astype(np.float32))), \
            (kind, n)


def test_dbht_entry_point_equals_jax():
    S, tm, _ = _inputs("clustered", 48, 64, "exact", seed=3)
    want = jdbht.dbht(S, tm, apsp_method="hub")
    got = tdbht.dbht(torch.from_numpy(S), interop.tmfg_from_numpy(tm, "cpu"),
                     apsp_method="hub")
    np.testing.assert_array_equal(got.linkage.numpy(), want.linkage)
    np.testing.assert_array_equal(got.converging.numpy(), want.converging)
    np.testing.assert_array_equal(got.direction.numpy(), want.direction)
    for k in (2, 4, 7):
        np.testing.assert_array_equal(got.labels(k), want.labels(k))


def test_dbht_refuses_unported_and_conflicting_knobs():
    S, tm, _ = _inputs("clustered", 24, 64, "exact")
    St, ttm = torch.from_numpy(S), interop.tmfg_from_numpy(tm, "cpu")
    with pytest.raises(ValueError, match="conflicts"):
        tdbht.dbht(St, ttm, config=PipelineConfig(), apsp_method="exact")
    with pytest.raises(ValueError, match="unknown DBHT impl"):
        tdbht.dbht(St, ttm, impl="gpu")
