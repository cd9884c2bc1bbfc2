"""The port's multi-device funnel (``repro_torch.dist``,
``repro_torch.core.distributed``, ``mesh=``) against the single-device
port and against JAX, on the CPU under gloo.

  * World size 1, in the test process (``data_mesh(device="cpu")``
    starts the group): ``cluster``, ``run_pipeline_device`` and
    ``cluster_batch`` with ``mesh=`` are bitwise the calls without it
    for OPT, approx and the sparse tail; a ``ClusterService`` with a
    mesh reclusters a window; ``fused_from_table`` is the lazy approx
    body after the table.
  * World size 4, one spawned group (tests/torch_dist_worker.py; the
    ranks import torch and ``repro_torch`` only, the JAX reference is
    computed here): the reference's own checks of
    tests/test_distributed.py (Pearson within 3e-5, the TMFG's
    insertion order for both ``collectives`` values, the per-element
    baseline at n = 24, hub APSP within
    1e-5, the sharded masked argmax and min-plus bitwise), the funnel
    against JAX's single-device ``run_pipeline_device`` (on S the
    linkage bitwise; from X the labels and merge structure, heights
    within 1e-4: the Pearson products round differently, as in
    tests/test_torch_pipeline.py), and a batch sharded over the ranks,
    each entry bitwise the port's ``cluster``.  What it measures of the
    row sums: at n = 64 the all-reduced sums pick the same clique, and
    the insertion order equals JAX's.
  * World size 3, one spawned group: the top-K table at n = 50 (rows
    padded to 51) bitwise the port's ``topk_split_ref`` and equal to
    JAX's ``topk_pearson_jnp``; the TMFG on uneven column
    blocks; the approx funnel from X bitwise the single-device call.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import apsp as japsp  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.tmfg import build_tmfg as jbuild  # noqa: E402
from repro.data.timeseries import make_dataset  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.topk import topk_pearson_jnp  # noqa: E402

import torch.distributed as dist  # noqa: E402

from repro_torch.approx import knn  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import PipelineConfig  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import fused_approx as tfa  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.kernels import ops, topk as ttopk  # noqa: E402
from repro_torch.kernels.ref import standardize_rows  # noqa: E402

import torch_dist_worker as worker  # noqa: E402

CONFIGS = {
    "opt": PipelineConfig.opt(),
    "approx": PipelineConfig.approx(sim_k=16),
    "sparse": PipelineConfig.opt().replace(apsp_method="sparse"),
}


@pytest.fixture(scope="module")
def mesh1():
    """A world-1 gloo mesh in this process, destroyed after the module."""
    assert not dist.is_initialized()
    mesh = tsh.data_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def X64():
    return make_dataset(64, 48, 4, seed=5)[0]


# ---------------------------------------------------------------------------
# world size 1
# ---------------------------------------------------------------------------

def test_data_mesh_starts_a_world_one_group(mesh1):
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    assert mesh1.mesh_dim_names == ("data",)
    assert tsh.axis_size(mesh1, "data") == 1
    assert tsh.data_axes(mesh1) == ("data",)
    assert tsh.data_mesh(device="cpu").size() == 1     # the group is kept
    with pytest.raises(ValueError, match="process group has 1"):
        tsh.data_mesh(2, device="cpu")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_world1_cluster_is_bitwise_without_mesh(mesh1, X64, name):
    cfg = CONFIGS[name]
    want = tcore.cluster(X64, k=4, config=cfg, device="cpu")
    got = tcore.cluster(X64, k=4, config=cfg, device="cpu", mesh=mesh1,
                        collect_timings=True)
    np.testing.assert_array_equal(got.linkage, want.linkage)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.edge_sum == want.edge_sum
    assert torch.equal(got.tmfg.insert_order, want.tmfg.insert_order)
    assert got.timings["tmfg_pops"] == float(want.tmfg.pops)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_world1_run_pipeline_device_is_bitwise_without_mesh(mesh1, X64,
                                                             name):
    cfg = CONFIGS[name]
    S = np.corrcoef(X64).astype(np.float32)
    for arr in (X64, S):
        want = tcore.run_pipeline_device(arr, cfg, device="cpu")
        got = tdist.run_pipeline_sharded(arr, cfg, mesh1, device="cpu")
        for f in ("linkage", "apsp", "cluster_of", "bubble_of",
                  "direction", "conv_mask"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert torch.equal(got.tmfg.edges, want.tmfg.edges)
        via = tcore.run_pipeline_device(arr, cfg, mesh=mesh1, device="cpu")
        assert torch.equal(via.linkage, want.linkage)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_world1_cluster_batch_is_bitwise_without_mesh(mesh1, name):
    cfg = CONFIGS[name]
    Xb = np.stack([make_dataset(48, 40, 3, noise=0.7, seed=s)[0]
                   for s in range(3)])
    want = tcore.cluster_batch(Xb, k=3, config=cfg, device="cpu")
    got = tcore.cluster_batch(Xb, k=3, config=cfg, device="cpu", mesh=mesh1,
                              limit=2)
    assert len(got) == 2
    np.testing.assert_array_equal(got.labels, want.labels[:2])
    for b in range(2):
        np.testing.assert_array_equal(got[b].linkage, want[b].linkage)
        assert got[b].edge_sum == want[b].edge_sum
        assert torch.equal(got[b].dbht.converging.long(),
                           want[b].dbht.converging.long())


def test_world1_service_with_a_mesh_reclusters_a_window(mesh1):
    from repro_torch.stream import ClusterService

    X, _ = make_dataset(32, 40, 4, noise=0.3, seed=11)
    kw = dict(n=32, window=24, k=4, max_batch=1, device="cpu")
    svc = ClusterService(**kw, mesh=mesh1)
    ref = ClusterService(**kw)
    for t in range(X.shape[1]):
        svc.tick(X[:, t])
        ref.tick(X[:, t])
    got, want = svc.recluster(), ref.recluster()
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.linkage, want.linkage)


def test_staged_cluster_ignores_the_mesh(mesh1, X64):
    want = tcore.cluster(X64, k=4, device="cpu", fused=False)
    got = tcore.cluster(X64, k=4, device="cpu", fused=False, mesh=mesh1)
    np.testing.assert_array_equal(got.linkage, want.linkage)


def test_mesh_refusals(mesh1, X64):
    with pytest.raises(TypeError, match="DeviceMesh"):
        tcore.cluster(X64, mesh="data", device="cpu")
    with pytest.raises(ValueError, match="one matrix"):
        tcore.run_pipeline_device(np.stack([X64, X64]), PipelineConfig(),
                                  mesh=mesh1, device="cpu")
    with pytest.raises(ValueError, match="host"):
        tdist.run_pipeline_sharded(X64, PipelineConfig(dbht_impl="host"),
                                   mesh1, device="cpu")
    with pytest.raises(ValueError, match="lazy only"):
        tdist.build_tmfg_sharded(np.corrcoef(X64), mesh1, method="corr")
    # a non-lazy builder on a sharded route raises, as the reference's
    # fused_from_table and build_tmfg_sharded do
    for cfg in (PipelineConfig.opt().replace(method="corr"),
                PipelineConfig.approx(sim_k=16).replace(method="orig")):
        with pytest.raises(ValueError, match="lazy only"):
            tcore.cluster(X64, k=4, config=cfg, device="cpu", mesh=mesh1)


@pytest.mark.parametrize("cfg", [PipelineConfig.opt().replace(filter="mst"),
                                 PipelineConfig.opt().replace(clean="rmt")],
                         ids=["mst", "rmt"])
def test_unsharded_configs_run_replicated(mesh1, X64, cfg):
    """A non-TMFG filter and the RMT cleaning have no sharded form: every
    rank runs the single-device program on the whole input."""
    want = tcore.cluster(X64, k=4, config=cfg, device="cpu")
    got = tcore.cluster(X64, k=4, config=cfg, device="cpu", mesh=mesh1)
    np.testing.assert_array_equal(got.linkage, want.linkage)
    np.testing.assert_array_equal(got.labels, want.labels)


def test_sharded_loop_is_a_cached_program(mesh1, X64):
    """The column-sharded lazy loop is built once per shape and group: a
    replayed dense ``cluster(mesh=)`` builds nothing."""
    from repro_torch import obs

    S = np.corrcoef(X64).astype(np.float32)
    first = tcore.cluster(S=S, k=4, device="cpu", mesh=mesh1)
    with obs.trace.watch_recompiles() as w:
        again = tcore.cluster(S=S, k=4, device="cpu", mesh=mesh1)
    assert w.count == 0
    np.testing.assert_array_equal(again.linkage, first.linkage)
    prog = tdist.sharded_program(64, mesh1, dev="cpu")
    assert prog.runs >= 2


@pytest.mark.parametrize("from_x", [True, False])
def test_fused_from_table_is_the_lazy_approx_body(X64, from_x):
    """``fused_one``'s lazy branch is ``fused_from_table`` after the
    table: the same run, from X and from S (the funnel's approx route
    holds it against JAX, below)."""
    cfg = PipelineConfig.approx(sim_k=16)
    X = torch.from_numpy(X64)
    if from_x:
        v, i = ops.topk(X, 16)
        src, arr = standardize_rows(X), X
    else:
        src = arr = torch.from_numpy(np.corrcoef(X64).astype(np.float32))
        v, i = knn.topk_from_similarity(src, 16)
    tail = tfa.fused_from_table(cfg, 64, from_x=from_x)((v, i), src)
    body = tfa.fused_one(cfg, not from_x, 64)(arr)
    assert torch.equal(tail["Z"], body["Z"])
    assert torch.equal(tail["D"], body["D"])
    for f in ("edges", "insert_order", "bubble_parent"):
        assert torch.equal(getattr(tail["tmfg"], f), getattr(body["tmfg"], f))
    assert tail["counters"] == body["counters"]
    assert tail["tmfg_host_syncs"] == body["tmfg_host_syncs"]


def test_fused_from_table_refusals():
    with pytest.raises(ValueError, match="lazy topk"):
        tfa.fused_from_table(PipelineConfig.opt(), 64)
    with pytest.raises(ValueError, match="lazy topk"):
        tfa.fused_from_table(PipelineConfig.approx().replace(method="corr"),
                             64)
    with pytest.raises(ValueError, match="n <="):
        tfa.fused_from_table(PipelineConfig.approx(), tfa.FUSED_MAX_N + 1)


@pytest.mark.parametrize("row0,count", [(0, 50), (0, 17), (17, 17), (34, 16),
                                        (49, 1), (3, 40)])
def test_topk_row_range_is_those_rows(row0, count):
    X = torch.from_numpy(make_dataset(50, 48, 4, seed=3)[0])
    fv, fi = ttopk.topk_split_ref(X, 7)
    for v, i in (ops.topk(X, 7, row_range=(row0, count)),
                 ttopk.topk_split_ref(X, 7, row_range=(row0, count))):
        assert torch.equal(v, fv[row0:row0 + count])
        assert torch.equal(i, fi[row0:row0 + count])
    with pytest.raises(ValueError, match="outside"):
        ops.topk(X, 7, row_range=(40, 11))


def test_block_split_follows_dtensor():
    assert [tsh.block(51, 3, r) for r in range(3)] == [(0, 17), (17, 17),
                                                      (34, 17)]
    assert [tsh.block(50, 3, r) for r in range(3)] == [(0, 17), (17, 17),
                                                      (34, 16)]
    assert tsh.block(5, 4, 3) == (5, 0)


# ---------------------------------------------------------------------------
# world size 4: one spawned group
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world4(tmp_path_factory, X64):
    tmp = tmp_path_factory.mktemp("world4")
    X = X64
    S = np.corrcoef(X).astype(np.float32)
    rng = np.random.default_rng(0)
    Sq = rng.normal(size=(32, 32)).astype(np.float32)
    mask = np.zeros(32, bool)
    mask[[1, 5]] = True
    A = rng.uniform(0, 5, size=(32, 32)).astype(np.float32)
    Bm = rng.uniform(0, 5, size=(32, 32)).astype(np.float32)
    ref = jbuild(jnp.asarray(S), method="lazy")
    # the per-element baseline makes about 46 gloo collectives a step, so
    # it runs on a smaller set than the batched build
    S24 = np.corrcoef(make_dataset(24, 48, 4, seed=5)[0]).astype(np.float32)
    Xb = np.stack([make_dataset(48, 40, 3, noise=0.7, seed=s)[0]
                   for s in range(4)])
    for name, a in (("X", X), ("S", S), ("Sq", Sq), ("mask", mask),
                    ("A", A), ("Bm", Bm), ("Xb", Xb), ("S24", S24),
                    ("edges", np.asarray(ref.edges))):
        np.save(tmp / f"{name}.npy", a)
    outs = worker.spawn("world4", 4, tmp)
    W = japsp.edge_lengths(64, ref.edges, jnp.asarray(S))
    want = dict(
        S=S, ref=ref, S24=S24,
        ref24=jbuild(jnp.asarray(S24), method="lazy"), Sq=Sq, mask=mask, A=A, Bm=Bm, Xb=Xb,
        apsp=np.asarray(japsp.apsp_hub(W, n_hubs=8, rounds=16)))
    return outs, want


def test_world4_ranks_agree(world4):
    outs, _ = world4
    for o in outs[1:]:
        assert o.keys() == outs[0].keys()
        for key in o:
            np.testing.assert_array_equal(o[key], outs[0][key], err_msg=key)


def test_world4_pearson_sharded(world4):
    outs, want = world4
    np.testing.assert_allclose(outs[0]["pearson"], want["S"], atol=3e-5)


@pytest.mark.parametrize("coll", ["batched", "per-element"])
def test_world4_tmfg_sharded_matches_reference(world4, coll):
    """n = 64 batched, n = 24 per-element (one collective per row and
    per value)."""
    outs, want = world4
    ref = want["ref"] if coll == "batched" else want["ref24"]
    np.testing.assert_array_equal(outs[0][f"insert_order_{coll}"],
                                  np.asarray(ref.insert_order))
    np.testing.assert_array_equal(outs[0][f"edges_{coll}"],
                                  np.asarray(ref.edges))
    np.testing.assert_allclose(outs[0][f"edge_sum_{coll}"],
                               np.asarray(ref.edge_sum), rtol=1e-4)


def test_world4_apsp_hub_sharded(world4):
    outs, want = world4
    np.testing.assert_allclose(outs[0]["apsp_sharded"], want["apsp"],
                               atol=1e-5)
    # a minimum is exact: bitwise the port's single-device apsp_hub
    np.testing.assert_array_equal(outs[0]["apsp_sharded"],
                                  outs[0]["apsp_single"])


def test_world4_masked_argmax_and_minplus_shardmap(world4):
    outs, want = world4
    rv, ri = jref.masked_argmax_ref(jnp.asarray(want["Sq"]),
                                    jnp.asarray(want["mask"]))
    np.testing.assert_array_equal(outs[0]["argmax_v"], np.asarray(rv))
    np.testing.assert_array_equal(outs[0]["argmax_i"], np.asarray(ri))
    np.testing.assert_array_equal(
        outs[0]["minplus"],
        np.asarray(jref.minplus_ref(jnp.asarray(want["A"]),
                                    jnp.asarray(want["Bm"]))))


@pytest.mark.parametrize("name", ["opt", "approx"])
def test_world4_funnel_matches_reference(world4, X64, name):
    outs, want = world4
    cfg = getattr(jcore.PipelineConfig, name)()
    on_S = jpipe.run_pipeline_device(want["S"], cfg, is_similarity=True)
    np.testing.assert_array_equal(outs[0][f"link_{name}_S"],
                                  np.asarray(on_S.linkage))
    from_X = np.asarray(jpipe.run_pipeline_device(X64, cfg,
                                                  is_similarity=False).linkage)
    got = outs[0][f"link_{name}_X"]
    np.testing.assert_array_equal(got[:, [0, 1, 3]], from_X[:, [0, 1, 3]])
    np.testing.assert_allclose(got[:, 2], from_X[:, 2], rtol=0, atol=1e-4)
    n = X64.shape[0]
    k = int(np.asarray(on_S.conv_mask).sum())
    np.testing.assert_array_equal(tcore.cut_linkage(got, n, k),
                                  tcore.cut_linkage(from_X, n, k))


def test_world4_cluster_batch_entries_are_cluster(world4):
    outs, want = world4
    for b in range(4):
        single = tcore.cluster(want["Xb"][b], k=3, config=PipelineConfig.opt(),
                               device="cpu")
        np.testing.assert_array_equal(outs[0]["batch_linkage"][b],
                                      single.linkage)
        np.testing.assert_array_equal(outs[0]["batch_labels"][b],
                                      single.labels)


# ---------------------------------------------------------------------------
# world size 3: one spawned group
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world3")
    X50 = make_dataset(50, 48, 4, seed=3)[0]
    np.save(tmp / "X50.npy", X50)
    np.save(tmp / "S50.npy", np.corrcoef(X50).astype(np.float32))
    return worker.spawn("world3", 3, tmp), X50


def test_world3_topk_table_is_the_single_device_table(world3):
    outs, X50 = world3
    assert [int(o["local_rows"][0]) for o in outs] == [17, 17, 16]
    X = torch.from_numpy(X50)
    sv, si = ttopk.topk_split_ref(X, 7)
    for o in outs:
        np.testing.assert_array_equal(o["topk_v"], sv.numpy())
        np.testing.assert_array_equal(o["topk_i"], si.numpy())
        np.testing.assert_array_equal(o["z"], standardize_rows(X).numpy())
    jv, ji = topk_pearson_jnp(jnp.asarray(X50), 7)
    np.testing.assert_array_equal(outs[0]["topk_i"], np.asarray(ji))
    np.testing.assert_allclose(outs[0]["topk_v"], np.asarray(jv), rtol=0,
                               atol=1e-6)


def test_world3_uneven_blocks_tmfg_and_approx_funnel(world3):
    outs, X50 = world3
    S = np.corrcoef(X50).astype(np.float32)
    ref = jbuild(jnp.asarray(S), method="lazy")
    single = tcore.cluster(X50, k=4, config=PipelineConfig.approx(sim_k=16),
                           device="cpu")
    for o in outs:
        np.testing.assert_array_equal(o["insert_order"],
                                      np.asarray(ref.insert_order))
        np.testing.assert_array_equal(o["approx_linkage"], single.linkage)
        np.testing.assert_array_equal(o["approx_labels"], single.labels)
