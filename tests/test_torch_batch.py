"""The port's pipeline entry points beside ``cluster(X)`` against the JAX
package: the approx path with a non-lazy method, ``dbht_batch`` and
``cluster_batch``, the ``reuse_tmfg`` warm start, the loose-kwargs shim
and the refusals.

Inputs are numpy seeds; the similarities are the reference's own
(``pearson_ref``) so that every comparison is bitwise: labels and
linkage, given one S.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from conftest import regime_batch  # noqa: E402
from repro.core import dbht as jdbht  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.data.timeseries import make_dataset  # noqa: E402
from repro.kernels.ref import pearson_ref  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import dbht as tdbht  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402


def _S_of(X):
    return np.asarray(pearson_ref(jnp.asarray(X)))


def _same_result(got, want, msg=""):
    np.testing.assert_array_equal(got.linkage, np.asarray(want.linkage),
                                  err_msg=msg)
    np.testing.assert_array_equal(got.labels, np.asarray(want.labels),
                                  err_msg=msg)


# ---------------------------------------------------------------------------
# (a) approx with a non-lazy method
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("method", ["corr", "orig"])
def test_approx_non_lazy_method_matches_reference(method, fused):
    """The densified table and the config's own builder, fused and
    staged, as the reference runs them: its linkage and labels bitwise
    (the parent ran the lazy build, or refused the fused body)."""
    X, _ = make_dataset(60, 40, 3, seed=0)
    S = _S_of(X)
    kw = dict(sim_k=16, method=method, topk=0, apsp_method="exact")
    want = jcore.cluster(S=S, config=jcore.PipelineConfig.approx(**kw),
                         fused=fused)
    got = tcore.cluster(S=S, config=tcore.PipelineConfig.approx(**kw),
                        fused=fused, device="cpu")
    _same_result(got, want, method)
    lazy = tcore.cluster(S=S, config=tcore.PipelineConfig.approx(sim_k=16),
                         device="cpu")
    assert not np.array_equal(got.tmfg.edges.numpy(), lazy.tmfg.edges.numpy())


# ---------------------------------------------------------------------------
# (f) dbht_batch and cluster_batch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def batch():
    Xb = regime_batch(3, 40)
    Sb = np.stack([_S_of(x) for x in Xb])
    return Xb, Sb


def _stack_jax(tms):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *tms)


@pytest.mark.parametrize("apsp_method", ["exact", "sparse"])
def test_dbht_batch_matches_entries_and_reference(batch, apsp_method):
    """Entry b of ``dbht_batch`` is the port's ``dbht`` on entry b, and
    JAX's ``dbht_batch`` entry; ``limit`` keeps the first entries."""
    _, Sb = batch
    tms = [jcore.build_tmfg(jnp.asarray(s, jnp.float32)) for s in Sb]
    jtm = _stack_jax(tms)
    ttm = interop.tmfg_from_numpy(jtm, "cpu")
    want = jdbht.dbht_batch(Sb, jtm, apsp_method=apsp_method, limit=2)
    got = tdbht.dbht_batch(torch.from_numpy(Sb), ttm,
                           apsp_method=apsp_method, limit=2)
    assert len(got) == len(want) == 2
    for b in range(2):
        single = tdbht.dbht(torch.from_numpy(Sb[b]),
                            interop.tmfg_from_numpy(tms[b], "cpu"),
                            apsp_method=apsp_method)
        for f in ("linkage", "cluster_of", "bubble_of", "converging",
                  "direction"):
            g = getattr(got[b], f).cpu().numpy()
            np.testing.assert_array_equal(g, np.asarray(getattr(want[b], f)))
            np.testing.assert_array_equal(
                g, getattr(single, f).cpu().numpy())
        assert got[b].linkage.device.type == "cpu"
    cfg = tcore.PipelineConfig(apsp_method=apsp_method)
    with pytest.raises(ValueError, match="conflicts"):
        tdbht.dbht_batch(torch.from_numpy(Sb), ttm, config=cfg,
                         backend="torch")


_BATCH_CONFIGS = {
    "opt": lambda m: m.PipelineConfig.opt(),
    "opt-sparse": lambda m: m.PipelineConfig(apsp_method="sparse"),
    "approx-sparse": lambda m: m.PipelineConfig.approx(
        sim_k=12, apsp_method="sparse"),
}


@pytest.mark.parametrize("name", sorted(_BATCH_CONFIGS))
def test_cluster_batch_matches_entries_and_reference(batch, name):
    """From S: each entry of ``cluster_batch`` (fused and staged) is
    bitwise the port's ``cluster`` of that entry, and the JAX package's
    ``cluster_batch`` entry; ``limit=2`` materialises two of three."""
    _, Sb = batch
    make = _BATCH_CONFIGS[name]
    # the approx batch is held against the port's own entries only: the
    # reference's vmapped approx programs are the slowest to compile
    want = (None if name.startswith("approx") else
            jcore.cluster_batch(S=Sb, k=3, config=make(jcore), fused=False))
    for fused in (True, False):
        got = tcore.cluster_batch(S=Sb, k=3, config=make(tcore), fused=fused,
                                  device="cpu", collect_timings=True)
        assert got.labels.shape == (3, 40) and len(got) == 3
        for b in range(3):
            one = tcore.cluster(S=Sb[b], k=3, config=make(tcore),
                                fused=fused, device="cpu")
            _same_result(got[b], one, f"{name} fused={fused} b={b}")
            if want is not None:
                _same_result(got[b], want[b], f"{name} fused={fused} b={b}")
        assert got.timings["total"] > 0
    lim = tcore.cluster_batch(S=Sb, k=3, config=make(tcore), limit=2,
                              device="cpu")
    assert len(lim) == 2 and lim.labels.shape == (2, 40)
    for b in range(2):
        _same_result(lim[b], got[b])


def test_cluster_batch_from_X_and_host_oracle(batch):
    """From X: entry b is ``cluster(X[b])``; the host oracle
    (``dbht_impl="host"``, staged only) gives the same batch."""
    Xb, _ = batch
    got = tcore.cluster_batch(Xb, k=3, device="cpu")
    host = tcore.cluster_batch(Xb, k=3, dbht_impl="host", fused=False,
                               device="cpu")
    for b in range(3):
        _same_result(got[b], tcore.cluster(Xb[b], k=3, device="cpu"))
        _same_result(host[b], got[b])
    with pytest.raises(ValueError, match="fused=True requires"):
        tcore.cluster_batch(Xb, dbht_impl="host", fused=True, device="cpu")
    with pytest.raises(ValueError, match="3-D"):
        tcore.cluster_batch(Xb[0], device="cpu")
    with pytest.raises(ValueError, match="limit"):
        tcore.cluster_batch(Xb, limit=0, device="cpu")


# ---------------------------------------------------------------------------
# (g) reuse_tmfg, the loose-kwargs shim and the refusals
# ---------------------------------------------------------------------------

def test_reuse_tmfg_reruns_only_dbht(batch):
    """A carried-over TMFG reruns the DBHT stage staged: on the window
    it was built from, the full run; on another window, the reference's
    warm start from the same TMFG, bitwise."""
    Xb, Sb = batch
    X, S, S2 = Xb[0], Sb[0], Sb[1]
    jtm = jcore.build_tmfg(jnp.asarray(S, jnp.float32))
    for cfg_t, cfg_j in ((tcore.PipelineConfig(), jcore.PipelineConfig()),
                         (tcore.PipelineConfig(apsp_method="sparse"),
                          jcore.PipelineConfig(apsp_method="sparse"))):
        full = tcore.cluster(S=S, config=cfg_t, device="cpu")
        warm = tcore.cluster(S=S, config=cfg_t, reuse_tmfg=full.tmfg,
                             device="cpu", collect_timings=True)
        _same_result(warm, full)
        assert warm.reused_tmfg and not full.reused_tmfg
        assert warm.timings["tmfg_host_syncs"] == 0
        want = jcore.cluster(S=S2, config=cfg_j, reuse_tmfg=jtm)
        got = tcore.cluster(S=S2, config=cfg_t, device="cpu",
                            reuse_tmfg=interop.tmfg_from_numpy(jtm, "cpu"))
        _same_result(got, want)
    with pytest.raises(ValueError, match="fused=True requires"):
        tcore.cluster(S=S, reuse_tmfg=full.tmfg, fused=True, device="cpu")
    with pytest.raises(ValueError, match="needs S="):
        tcore.cluster(X, config=tcore.PipelineConfig.approx(sim_k=8),
                      reuse_tmfg=full.tmfg, device="cpu")
    _same_result(
        tcore.cluster(S=S2, reuse_tmfg=interop.tmfg_from_numpy(jtm, "cpu"),
                      config=tcore.PipelineConfig.approx(sim_k=8),
                      device="cpu"),
        jcore.cluster(S=S2, reuse_tmfg=jtm,
                      config=jcore.PipelineConfig.approx(sim_k=8)))


def test_loose_kwargs_shim_and_resolve_variant():
    """The loose kwargs and ``variant=`` resolve to the configs the
    reference resolves them to; combining them with ``config=`` raises."""
    X, _ = make_dataset(40, 30, 3, seed=3)
    S = _S_of(X)
    for variant in sorted(tcore.VARIANTS):
        assert (tpipe.resolve_variant(variant)
                == jpipe.resolve_variant(variant))
    assert (tpipe.resolve_variant(None, method="corr", topk=0)
            == jpipe.resolve_variant(None, method="corr", topk=0))
    P = tcore.PipelineConfig
    cases = [(dict(variant="corr"), P.corr()),
             (dict(variant="par-10", backend="torch"),
              P.par(10, backend="torch")),
             (dict(method="corr", topk=0, apsp_method="exact"),
              P(method="corr", topk=0, apsp_method="exact")),
             (dict(apsp_method="sparse", dbht_impl="host"),
              P(apsp_method="sparse", dbht_impl="host"))]
    for kw, cfg in cases:
        _same_result(
            tcore.cluster(S=S, k=3, device="cpu", fused=False, **kw),
            tcore.cluster(S=S, k=3, config=cfg, device="cpu", fused=False),
            str(kw))
    _same_result(tcore.cluster(S=S, k=3, variant="corr", device="cpu"),
                 jcore.cluster(S=S, k=3, variant="corr"))
    with pytest.raises(ValueError, match="conflicts with \\['method'\\]"):
        tcore.cluster(S=S, config=tcore.PipelineConfig(), method="corr",
                      device="cpu")
    with pytest.raises(ValueError, match="conflicts with \\['variant'\\]"):
        tcore.cluster_batch(S=S[None], config=tcore.PipelineConfig(),
                            variant="opt", device="cpu")


def test_unported_hooks_raise_with_their_roadmap_item():
    X, _ = make_dataset(24, 20, 2, seed=4)
    # mesh= is ported (ROADMAP item 14 closed): an object that is not a
    # DeviceMesh now raises TypeError instead of NotImplementedError
    with pytest.raises(TypeError, match="DeviceMesh"):
        tcore.cluster(X, mesh=object(), device="cpu")
    # moments= is ported (ROADMAP item 12 closed): it now clusters the
    # window's co-moment similarity instead of raising
    from repro_torch.stream import window as twindow
    st = twindow.window_push_block(twindow.window_init(24, 20), X)
    got = tcore.cluster(moments=st, k=2, device="cpu")
    want = tcore.cluster(S=twindow.window_similarity(st), k=2, device="cpu")
    np.testing.assert_array_equal(got.linkage, want.linkage)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tcore.cluster_batch(X[None], mesh=object(), device="cpu")
