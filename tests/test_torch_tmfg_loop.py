"""The port's TMFG builders as device loops (``repro_torch.core.tmfg``).

  * CORR and ORIG with prefix 1, 10 and 200 give every ``TMFGResult``
    field, ``pops`` included, bitwise JAX's ``build_tmfg`` on the same
    float32 S (dtype and bits), on the adversarial ``random_symmetric``
    and the clustered ``make_dataset`` inputs, n in {4, 5, 24, 48} (the
    lazy method's cases: tests/test_torch_tmfg.py).
  * T, the lazy steps per read of the inserted count, in {1, 7, 64}
    gives one build bit for bit (a step past the end is an exact no-op)
    within ``ceil(pops / T) + 3`` host syncs, for the dense source and
    the table-first one, whose ``SparseCounters`` equal the reference's
    at K = n-1 and K < n-1.
  * The port's numpy oracle (``core/tmfg_ref.py``) is the reference's,
    and agrees with the port's builders on well-separated clusters.
  * ``cluster()`` gives ``repro.core.cluster``'s labels and linkage for
    every paper variant, from the reference's own S.
  * CORR's per-step scan, ``masked_argmax_ref``, gives ``jnp.argmax``'s
    index on rows whose unmasked entries are all -inf.

All inputs come from numpy seeds; every comparison is exact except the
edge values from the standardized series Z (within 1e-6: the fallback
dot products round otherwise, as in tests/test_torch_approx.py).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from conftest import clustered_similarity, random_symmetric  # noqa: E402
from repro.approx import knn as jknn  # noqa: E402
from repro.approx import sparse_tmfg as jsparse  # noqa: E402
from repro.core import tmfg as jtmfg  # noqa: E402
from repro.core import tmfg_ref as jref  # noqa: E402
from repro.data.timeseries import make_dataset  # noqa: E402
from repro.kernels.ref import pearson_ref as jpearson  # noqa: E402
from repro.kernels.ref import standardize_rows as jstd  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.approx import sparse_tmfg as tsparse  # noqa: E402
from repro_torch.core import tmfg as ttmfg  # noqa: E402
from repro_torch.core import tmfg_ref as tref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

BUILDERS = {
    "lazy-0": dict(method="lazy", topk=0),
    "lazy-64": dict(method="lazy", topk=64),
    "corr": dict(method="corr"),
    "orig-1": dict(method="orig", prefix=1),
    "orig-10": dict(method="orig", prefix=10),
    "orig-200": dict(method="orig", prefix=200),
}


def _similarity(kind, n, seed):
    if kind == "random":
        return random_symmetric(n, seed).astype(np.float32)
    X, _ = make_dataset(n, 40, 4, noise=0.8, seed=seed)
    return np.corrcoef(X).astype(np.float32)


def _assert_tmfg_equal(jres, tres, skip=()):
    for f in jres._fields:
        if f in skip:
            continue
        want = np.asarray(getattr(jres, f))
        got = getattr(tres, f).cpu().numpy()
        assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("builder", ["corr", "orig-1", "orig-10",
                                     "orig-200"])
@pytest.mark.parametrize("n", [4, 5, 24, 48])
@pytest.mark.parametrize("kind", ["random", "clustered"])
def test_builder_equals_jax(kind, n, builder):
    S = _similarity(kind, n, seed=n + len(builder))
    kw = BUILDERS[builder]
    jres = jtmfg.build_tmfg(jnp.asarray(S), **kw)
    tres = tcore.build_tmfg(torch.from_numpy(S), **kw)
    _assert_tmfg_equal(jres, tres)


def test_orig_row_panels_do_not_change_the_build(monkeypatch):
    """ORIG's (F, n) face-row sums in panels of 7 rows (the last one
    short) are the reference's one (F, n) reduction."""
    S = _similarity("clustered", 48, 3)
    monkeypatch.setattr(ttmfg, "ORIG_PANEL_ELEMS", 7 * 48)
    for prefix in (1, 10):
        jres = jtmfg.build_tmfg(jnp.asarray(S), method="orig", prefix=prefix)
        tres = ttmfg.build_tmfg(torch.from_numpy(S), method="orig",
                                prefix=prefix)
        _assert_tmfg_equal(jres, tres)


# ---------------------------------------------------------------------------
# steps per sync, host syncs, the table-first source
# ---------------------------------------------------------------------------

_N = 48
SOURCES = ("dense-0", "dense-64", "table-S-full", "table-S-8", "table-Z-8")


def _source_inputs(source):
    X, _ = make_dataset(_N, 40, 4, noise=0.8, seed=5)
    S = np.array(jpearson(jnp.asarray(X)))
    if source.startswith("dense"):
        return S, None
    k = _N - 1 if source.endswith("full") else 8
    return S, jknn.topk_from_similarity(jnp.asarray(S), k) \
        if "-S-" in source else jknn.topk_pearson(jnp.asarray(X), k)


def _reference(source):
    S, jt = _source_inputs(source)
    if jt is None:
        topk = int(source.split("-")[1])
        return jtmfg.build_tmfg(jnp.asarray(S), method="lazy", topk=topk), \
            None, None
    if "-S-" in source:
        return jsparse.build_tmfg_sparse(jt, S=jnp.asarray(S))
    X, _ = make_dataset(_N, 40, 4, noise=0.8, seed=5)
    return jsparse.build_tmfg_sparse(jt, Xn=jstd(jnp.asarray(X)))


def _port(source):
    """(TMFGResult, edge values or None, counters or None, host syncs)."""
    S, jt = _source_inputs(source)
    if jt is None:
        topk = int(source.split("-")[1])
        res, syncs = ttmfg._build(ttmfg.prepare_similarity(
            torch.from_numpy(S)), "lazy", topk=topk)
        return res, None, None, syncs
    table = interop.table_from_numpy(jt, "cpu")
    stats = {}
    if "-S-" in source:
        res, w, c = tsparse.build_tmfg_sparse(table, S=torch.from_numpy(S),
                                              stats=stats)
    else:
        X, _ = make_dataset(_N, 40, 4, noise=0.8, seed=5)
        Z = torch.from_numpy(np.asarray(jstd(jnp.asarray(X))))
        res, w, c = tsparse.build_tmfg_sparse(table, Xn=Z, stats=stats)
    return res, w, c, stats["host_syncs"]


@pytest.mark.parametrize("T", [1, 7, 64])
@pytest.mark.parametrize("source", SOURCES)
def test_steps_per_sync_give_one_build(monkeypatch, source, T):
    monkeypatch.setattr(ttmfg, "STEPS_PER_SYNC", T)
    jres, jw, jc = _reference(source)
    res, w, c, syncs = _port(source)
    from_z = source.startswith("table-Z")
    _assert_tmfg_equal(jres, res, skip=("edge_sum",) if from_z else ())
    pops = int(res.pops)
    assert syncs == math.ceil(pops / T) + 1
    assert syncs <= math.ceil(pops / T) + 3
    if jw is None:
        return
    if from_z:
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0,
                                   atol=1e-6)
        assert c.fallbacks > 0 and c.pair_misses > 0
    else:
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert tuple(c) == tuple(int(x) for x in jc)
    if source == "table-S-full":
        assert c.pair_misses == 0


def _snapshot(st):
    """Every field of a lazy or ORIG state without its trash row."""
    return [t.clone() if t.shape == (1,) else t[:-1].clone()
            for t in st if t is not None]


def test_steps_past_the_end_are_exact_no_ops():
    """Once all n vertices are in, a lazy step and an ORIG round change
    no field of the state outside the trash rows: counts and pops
    included."""
    S = ttmfg.prepare_similarity(torch.from_numpy(
        _similarity("random", 24, 7)))
    n = S.shape[0]
    for table in (None, ttmfg.candidate_table(S, 8)):
        d = ttmfg._Device(S, table)
        st = ttmfg._init_state(d)
        ttmfg.run_loop(lambda: ttmfg.lazy_step(st, d), st, n, 5)
        before = _snapshot(st)
        for _ in range(3):
            ttmfg.lazy_step(st, d)
        for a, b in zip(before, _snapshot(st)):
            assert torch.equal(a, b)
    d = ttmfg._Device(S, None)
    st = ttmfg._init_state(d)
    slot = torch.arange(2 * n - 4)
    ttmfg.run_loop(lambda: ttmfg.orig_round(st, d, slot, 10, "torch"), st, n,
                   1)
    before = _snapshot(st)
    ttmfg.orig_round(st, d, slot, 10, "torch")
    for a, b in zip(before, _snapshot(st)):
        assert torch.equal(a, b)


def test_corr_reads_the_count_once():
    S = torch.from_numpy(_similarity("clustered", 24, 2))
    res, syncs = ttmfg._build(ttmfg.prepare_similarity(S), "corr")
    assert syncs == 1 and int(res.pops) == 20


# ---------------------------------------------------------------------------
# the numpy oracle
# ---------------------------------------------------------------------------

ORACLES = {
    "exact": lambda m, S: m.tmfg_exact(S),
    "orig-10": lambda m, S: m.tmfg_orig(S, prefix=10),
    "corr": lambda m, S: m.tmfg_corr(S),
    "lazy": lambda m, S: m.tmfg_lazy(S),
}


@pytest.mark.parametrize("oracle", sorted(ORACLES))
def test_oracle_copy_is_the_reference(oracle):
    S, _, _ = clustered_similarity(30, seed=4)
    want = ORACLES[oracle](jref, S)
    got = ORACLES[oracle](tref, S)
    for f in ("clique", "edges", "faces", "insert_order", "bubble_verts",
              "bubble_parent", "bubble_tri", "home_bubble"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.edge_sum == want.edge_sum


@pytest.mark.parametrize("builder,oracle", [
    ("lazy-0", "lazy"), ("lazy-64", "lazy"), ("corr", "corr"),
    ("orig-1", "exact"), ("orig-10", "orig-10")])
@pytest.mark.parametrize("n", [24, 48])
def test_builders_agree_with_numpy_oracle(n, builder, oracle):
    """On well-separated clusters (no near-ties) the float32 device
    builders insert in the float64 oracle's order."""
    S, _, _ = clustered_similarity(n, seed=n)
    want = ORACLES[oracle](tref, S)
    got = tcore.build_tmfg(torch.from_numpy(S), **BUILDERS[builder])
    np.testing.assert_array_equal(got.insert_order.numpy(), want.insert_order)
    np.testing.assert_array_equal(np.sort(got.edges.numpy(), axis=1),
                                  want.edges)
    np.testing.assert_allclose(float(got.edge_sum), want.edge_sum, rtol=1e-4)


# ---------------------------------------------------------------------------
# the whole pipeline, every variant
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def variant_S():
    X, _ = make_dataset(60, 46, 4, noise=0.7, seed=11)
    return np.asarray(jpearson(jnp.asarray(X)))


@pytest.mark.parametrize("variant", sorted(tcore.VARIANTS))
def test_cluster_every_variant_equals_reference(variant_S, variant):
    want = jcore.cluster(S=variant_S, k=4,
                         config=jcore.PipelineConfig.variant(variant))
    got = tcore.cluster(S=variant_S, k=4, device="cpu", collect_timings=True,
                        config=tcore.PipelineConfig.variant(variant))
    np.testing.assert_array_equal(got.linkage, np.asarray(want.linkage))
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.edge_sum == want.edge_sum
    assert got.timings["tmfg_host_syncs"] >= 1


# ---------------------------------------------------------------------------
# CORR's scan on rows with nothing left to find
# ---------------------------------------------------------------------------

def test_masked_argmax_ref_on_all_neg_inf_rows():
    """Rows whose unmasked entries are all -inf (the -inf diagonal the
    only unmasked column, or every column masked) give the index of the
    reference's ``jnp.argmax(where(inserted, NEG, S))``: the lowest
    column overall, as every other row does."""
    r = np.random.default_rng(8)
    n = 9
    S = r.normal(size=(n, n)).astype(np.float32)
    np.fill_diagonal(S, -np.inf)
    for free in ([5], [], [0], [3, 7]):
        mask = np.ones(n, bool)
        mask[free] = False
        want = np.asarray(jnp.argmax(jnp.where(jnp.asarray(mask)[None, :],
                                               -jnp.inf, jnp.asarray(S)),
                                     axis=1))
        _, got = ref.masked_argmax_ref(torch.from_numpy(S),
                                       torch.from_numpy(mask))
        np.testing.assert_array_equal(got.numpy(), want)
