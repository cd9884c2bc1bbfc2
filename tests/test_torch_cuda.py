"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips, with the reason, where
there is no GPU (a CUDA kernel has no CPU mode).  The file imports no
JAX, so it runs on a machine with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: Pearson within 1e-5 absolute of the plain version (the
kernel multiplies by the inverse norm where the plain version divides by
the norm, and sums in another order); min-plus, masked argmax and the
sparse relaxation bitwise, NaN entries at the same places; top-K bitwise
equal to a stable top-k of the Pearson kernel's own rows (NaN first, at
the same places), and within
1e-6 of the plain top-K (a PyTorch matmul rounds otherwise) for L up to
200, within L * 2**-24 for the long series; flash attention within 1e-5
of the plain version in fp32 (another summation order of the online
softmax) and, in bf16 (the wgmma kernel), within one bf16 ulp of the
plain output's largest magnitude (both round nearly equal fp32 values to
bf16 once; the kernel also rounds P to bf16 before the PV product); the
flash backward within 1e-5 (fp32) and 2^-7 (bf16) of each gradient's
largest magnitude, and bitwise repeatable; the bf16 and fp32 forwards'
outputs bitwise the same with their lse output on and off, and that
lse within 1e-5 * max(1, |lse|) of the plain masked logsumexp (fp32
online sums).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import PipelineConfig, cluster  # noqa: E402
from repro_torch.data.timeseries import make_dataset  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import sparse_apsp as sp  # noqa: E402
from repro_torch.kernels.pearson import pearson_cuda  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rng(seed):
    return np.random.default_rng(seed)


def _dist(rng, shape, inf_frac):
    A = rng.uniform(0, 5, shape).astype(np.float32)
    if inf_frac:
        A[rng.random(shape) < inf_frac] = np.inf
    return A


def _same(a, b):
    """Bitwise equal, NaN entries at the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        torch.where(na, 0.0, a), torch.where(nb, 0.0, b)))


def _with_nan(rng, A, count):
    """A copy of A with NaN at ``count`` random places."""
    A = A.copy()
    A.reshape(-1)[rng.choice(A.size, count, replace=False)] = np.nan
    return A


# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n,L", [(1, 3), (65, 46), (130, 17), (300, 200)])
def test_cuda_pearson_matches_plain(cuda, n, L):
    X = torch.from_numpy(_rng(n).normal(size=(n, L)).astype(np.float32))
    X = X.to(cuda)
    before = ops.KERNELS["pearson"].launches
    got = ops.pearson(X, backend="cuda")
    torch.cuda.synchronize()
    assert ops.KERNELS["pearson"].launches == before + 1
    assert float((got - ref.pearson_ref(X)).abs().max()) <= 1e-5
    assert torch.equal(got, got.T)


@pytest.mark.cuda
@pytest.mark.parametrize("n,L", [
    (131, 46),     # n % 4 == 3: 4-byte stores, one row past a tile
    (257, 17),     # two tiles and one row, L below one 16-deep step
    (258, 64),     # n % 4 == 2, L a multiple of the step
    (1001, 46),    # 36 tiles on fewer blocks than the grid's 264
    (5003, 33),    # 820 tiles: several per block of the persistent grid
])
def test_cuda_pearson_ragged_symmetric_and_topk_at_full_k(cuda, n, L):
    """Ragged n through both store paths: bitwise symmetric, within 1e-5
    of the plain version, and every value bitwise the top-K kernel's at
    k = n - 1 (the two kernels share Z and the FMA sequence)."""
    X = _rng(n + L).normal(size=(n, L)).astype(np.float32)
    X[1::9] = X[0]                  # duplicate rows: exact ties and +-1
    X = torch.from_numpy(X).to(cuda)
    got = pearson_cuda(X)
    v, i = ops.topk(X, n - 1, backend="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, got.T)
    assert float((got - ref.pearson_ref(X)).abs().max()) <= 1e-5
    P = got.clone()
    P.fill_diagonal_(float("-inf"))
    sv, si = torch.sort(P, dim=1, descending=True, stable=True)
    assert torch.equal(v, sv[:, :n - 1])
    assert torch.equal(i, si[:, :n - 1].int())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [300, 301])
def test_cuda_pearson_refuses_scratch_of_another_shape(cuda, n):
    """The entry point takes the scratch's (Lp, Np) with it and refuses
    any other than its own tiling's, counting no launch; the plan's own
    shape launches."""
    from repro_torch.kernels import pearson
    L = 46
    X = torch.from_numpy(_rng(n).normal(size=(n, L)).astype(np.float32)) \
        .to(cuda)
    pl = pearson.plan(n, L)
    mu, rs = pearson.row_stats(X)
    out = torch.empty((n, n), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    before = pearson.KERNEL.launches
    for Lp, Np in ((pl.Lp, pl.Np - 32), (pl.Lp, pl.Np + 32),
                   (pl.Lp - 16, pl.Np), (pl.Lp + 16, pl.Np)):
        zt = torch.empty((max(Lp, 1), Np), device=cuda)
        with pytest.raises(RuntimeError, match="cudaError"):
            pearson.KERNEL.launch(X.data_ptr(), mu.data_ptr(), rs.data_ptr(),
                                  zt.data_ptr(), out.data_ptr(), n, L, Lp, Np,
                                  stream=stream)
    assert pearson.KERNEL.launches == before
    zt = torch.empty((pl.Lp, pl.Np), device=cuda)
    pearson.KERNEL.launch(X.data_ptr(), mu.data_ptr(), rs.data_ptr(),
                          zt.data_ptr(), out.data_ptr(), n, L, pl.Lp, pl.Np,
                          stream=stream)
    torch.cuda.synchronize()
    assert torch.equal(out, pearson_cuda(X))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (1, 1, 1), (17, 33, 9), (130, 7, 127), (140, 300, 300), (300, 140, 300),
    # the hub round's form (140 rows of a 144-row tile) split over k, k
    # not a multiple of the 32-deep panel; the composition's form at an
    # odd n (4-byte copies, scalar stores); m = 1 and k = 1; one row past
    # a tile; k an exact multiple of the panel
    (140, 4099, 4099), (2000, 140, 2003), (130, 64, 131), (1, 1, 300),
    (1, 300, 1), (145, 64, 260), (140, 4096, 4096)])
def test_cuda_minplus_bitwise(cuda, m, k, n):
    rng = _rng(m + k + n)
    A = torch.from_numpy(_dist(rng, (m, k), 0.3)).to(cuda)
    B = torch.from_numpy(_dist(rng, (k, n), 0.3)).to(cuda)
    A0, B0 = A.clone(), B.clone()
    got = ops.minplus(A, B, backend="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, ref.minplus_ref(A, B))
    assert torch.equal(A, A0) and torch.equal(B, B0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(17, 33, 9), (140, 300, 300),
                                   (140, 2048, 2051)])
def test_cuda_minplus_propagates_nan_as_plain(cuda, m, k, n):
    """NaN operands, and -inf ones that meet +inf (NaN too) or give -inf,
    at the plain version's places; (140, 2048, 2051) folds split-k
    partial tiles."""
    rng = _rng(7 * m + k)
    A = _with_nan(rng, _dist(rng, (m, k), 0.3), 2)
    A.reshape(-1)[rng.choice(A.size, 3, replace=False)] = -np.inf
    A = torch.from_numpy(A)
    B = torch.from_numpy(_with_nan(rng, _dist(rng, (k, n), 0.3), 2))
    got = ops.minplus(A.to(cuda), B.to(cuda), backend="cuda")
    want = ref.minplus_ref(A.to(cuda), B.to(cuda))
    torch.cuda.synchronize()
    assert bool(torch.isnan(want).any()) and bool(torch.isneginf(want).any())
    assert _same(got, want)


def _check_topk(dev, n, L, k, tol, nan=False):
    rng = _rng(n + L + k)
    X = rng.normal(size=(n, L)).astype(np.float32)
    X[1::7] = X[0]                  # duplicate rows: exact value ties
    if nan:
        X[n // 3, 2] = np.nan       # a NaN series: a NaN row and column
    X = torch.from_numpy(X).to(dev)
    before = ops.KERNELS["topk"].launches
    v, i = ops.topk(X, k, backend="cuda")
    torch.cuda.synchronize()
    assert ops.KERNELS["topk"].launches == before + 1
    P = pearson_cuda(X)
    P.fill_diagonal_(float("-inf"))
    sv, si = torch.sort(P, dim=1, descending=True, stable=True)
    assert _same(v, sv[:, :k]) and torch.equal(i, si[:, :k].int())
    pv, _ = ref.topk_pearson_ref(X, k)
    assert float((v - pv).nan_to_num().abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,k", [(2, 3, 1), (65, 46, 64), (130, 17, 5),
                                   (300, 46, 299), (700, 46, 64),
                                   (1000, 200, 999), (5000, 46, 4999)])
def test_cuda_topk_is_a_stable_topk_of_the_pearson_kernel(cuda, n, L, k):
    _check_topk(cuda, n, L, k, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,k,nan", [
    (3001, 46, 64, False),   # 1128 tiles over 264 blocks: 4-7 pieces a panel
    (3001, 46, 64, True),    # ... with a NaN series
    (2909, 33, 64, False),   # the largest k with the lists in shared memory
    (2909, 33, 65, False),   # the smallest k with them in device memory
    (77, 30, 76, False),     # k = n - 1, two panels, lists in device memory
    (1333, 46, 1332, True),  # k = n - 1, lists in device memory, NaN
    (9001, 46, 64, False),   # 6 pieces per panel at most, ragged last panel
    (16950, 12, 64, False),  # more panels (265) than blocks (264)
    (17000, 20, 64, True),   # ... with a NaN series
])
def test_cuda_topk_split_merge_is_a_stable_topk(cuda, n, L, k, nan):
    """The column split (stream-K runs cut into pieces, merged per row by
    a second kernel) at n not a multiple of either tile, k = n - 1 and
    both list placements, with duplicated rows whose exact ties straddle
    the pieces' boundaries, and NaN ranked first."""
    _check_topk(cuda, n, L, k, 1e-6, nan=nan)


@pytest.mark.cuda
@pytest.mark.parametrize("n,L", [(2400, 1024), (1370, 2709)])
def test_cuda_topk_streams_long_series(cuda, n, L):
    """Series of several shared-memory chunks (the Mallat and HandOutlines
    lengths): still bitwise the Pearson kernel's rows.  Against the plain
    top-K the bound is L * 2**-24, the first-order bound on the difference
    of two float32 sums of L products of standardised series."""
    _check_topk(cuda, n, L, 64, L * 2.0 ** -24)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,row0,count", [
    (3001, 64, 0, 751), (3001, 64, 751, 751), (3001, 64, 2999, 2),
    (3001, 64, 17, 1000),    # a range not on a 4-row boundary
    (2909, 65, 5, 1500),     # lists in device memory
    (77, 76, 40, 37),        # k = n - 1
])
def test_cuda_topk_row_range_is_those_rows(cuda, n, k, row0, count):
    """A row range (the sharded funnel's row panel) is bitwise those rows
    of the whole launch, and of the plain version's row range."""
    X = torch.from_numpy(_rng(n + k).normal(size=(n, 46)).astype(
        np.float32)).to(cuda)
    before = ops.KERNELS["topk"].launches
    fv, fi = ops.topk(X, k, backend="cuda")
    v, i = ops.topk(X, k, backend="cuda", row_range=(row0, count))
    assert ops.KERNELS["topk"].launches == before + 2
    assert v.shape == (count, k) and i.shape == (count, k)
    assert torch.equal(v, fv[row0:row0 + count])
    assert torch.equal(i, fi[row0:row0 + count])
    pv, _ = ops.topk(X, k, backend="torch", row_range=(row0, count))
    assert float((pv - v).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_cuda_world1_funnel_is_the_single_card_run(cuda):
    """``mesh=`` on a world-1 NCCL group: the dense funnel on one S and
    the approx funnel from X are bitwise the runs without it."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import data_mesh

    assert not dist.is_initialized()
    X, _ = make_dataset(600, 46, 6, noise=0.5, seed=3)
    S = ops.pearson(torch.from_numpy(X).to(cuda))
    mesh = data_mesh()
    try:
        for arr, cfg in ((S, PipelineConfig.opt()),
                         (X, PipelineConfig.approx(sim_k=32))):
            kw = dict(S=arr) if arr is S else dict(X=arr)
            want = cluster(k=6, config=cfg, **kw)
            got = cluster(k=6, config=cfg, mesh=mesh, **kw)
            np.testing.assert_array_equal(got.linkage, want.linkage)
            assert torch.equal(got.tmfg.insert_order, want.tmfg.insert_order)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_world1_placed_train_step_is_the_unplaced_step(cuda):
    """``make_train_step(model, run_cfg, mesh)`` on a world-1 NCCL
    ("data", "model") mesh, the parameters and AdamW state laid out by
    ``param_shardings`` and the batch by ``batch_shardings``: two steps of
    a reduced bf16 granite (2 layers, hd 64, through the flash kernels)
    bitwise the steps without a mesh, losses and every leaf."""
    import torch.distributed as dist

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.train import optimizer
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.tree import leaves, tree_map

    assert not dist.is_initialized()
    cfg = get_config("granite-3-8b").reduced(n_layers=2, dtype="bfloat16",
                                             head_dim=64)
    model = build_model(cfg, device=cuda)
    p0 = model.init(torch.Generator(device=cuda).manual_seed(0))
    rng = _rng(7)
    batches = [{k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64))
                                    .astype(np.int32)).to(cuda)
                for k in ("tokens", "targets")} for _ in range(2)]
    rc = RunConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    p, o = p0, optimizer.init(p0)
    plain = make_train_step(model, rc)
    want = []
    for b in batches:
        p, o, met = plain(p, o, b)
        want.append(float(met["loss"]))
    mesh = make_mesh((1, 1), ("data", "model"))
    try:
        assert dist.get_backend() == "nccl"

        def place(tree, shardings):
            return tree_map(lambda x, s: s.place(x), tree, shardings)

        state = (p0, optimizer.init(p0))
        pm, om = place(state, sh.param_shardings(state, mesh))
        step = make_train_step(model, rc, mesh)
        ops.reset_launch_counts()
        got = []
        for b in batches:
            pm, om, met = step(pm, om, place(b, sh.batch_shardings(mesh, b)))
            got.append(float(met["loss"]))
        counts = ops.launch_counts()
        assert got == want
        assert all(torch.equal(sh.whole(a), b)
                   for a, b in zip(leaves((pm, om)), leaves((p, o))))
        assert counts["flash_attention_wgmma"] == 2 * 2 * cfg.n_layers
        assert counts["flash_attention_bwd_wgmma_dq"] == 2 * cfg.n_layers
    finally:
        dist.destroy_process_group()


def _random_csr(rng, n, m, dev):
    e = rng.integers(0, n, (m, 2))
    e = e[e[:, 0] != e[:, 1]]
    e = np.unique(np.sort(e, axis=1), axis=0)
    w = rng.uniform(0.1, 2.0, e.shape[0]).astype(np.float32)
    return sp.csr_from_edges(n, torch.from_numpy(e).to(dev),
                             torch.from_numpy(w).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,m", [(1, 5, 8), (9, 300, 900), (140, 2000, 6000)])
def test_cuda_sparse_relax_bitwise_nan_included(cuda, s, n, m):
    rng = _rng(s + n + m)
    g = _random_csr(rng, n, m, cuda)
    D = _with_nan(rng, _dist(rng, (s, n), 0.5), max(1, s * n // 50))
    D = torch.from_numpy(D).to(cuda)
    got, ch = ops.sparse_relax(D, g, backend="cuda")
    want = ref.sparse_relax_ref(D, g.indptr, g.cols, g.vals)
    torch.cuda.synchronize()
    assert _same(got, want)
    assert int(ch.item()) == int(bool((want < D).any()))


def _apollonian_csr(rng, n, dev):
    from repro_torch.data.graphs import apollonian_edges
    e = apollonian_edges(n, seed=int(rng.integers(1 << 30)))
    w = rng.uniform(0.1, 2.0, e.shape[0]).astype(np.float32)
    return sp.csr_from_edges(n, torch.from_numpy(e).to(dev),
                             torch.from_numpy(w).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 33, 140])
@pytest.mark.parametrize("n", [300, 5000])
def test_cuda_sparse_relax_apollonian_bitwise(cuda, s, n):
    """A TMFG's degree shape (rows of several work items, folded by the
    last to arrive) and sources not a multiple of 32: one round bitwise
    the plain version's, NaN included, twice over (the fold's counters
    reset), and the fixed point from the hubs by strength, with one
    launch per round."""
    rng = _rng(s + n)
    g = _apollonian_csr(rng, n, cuda)
    s = min(s, n)
    plan = sp.relax_plan(g.indptr)
    assert plan.n_slots > 0
    D = _with_nan(rng, _dist(rng, (s, n), 0.5), max(1, s * n // 50))
    D = torch.from_numpy(D).to(cuda)
    want = ref.sparse_relax_ref(D, g.indptr, g.cols, g.vals)
    for _ in range(2):
        got, ch = sp.sparse_relax_cuda(D, g.indptr, g.cols, g.vals, plan)
        torch.cuda.synchronize()
        assert _same(got, want)
        assert int(ch.item()) == int(bool((want < D).any()))
    assert not bool(plan.counters.any())
    hubs = torch.sort(sp.hub_strength(g), descending=True,
                      stable=True)[1][:s]
    sc, st = {}, {}
    before = ops.KERNELS["sparse_relax"].launches
    Dk = sp.sparse_apsp_sources(g, hubs, backend="cuda", stats=sc)
    launches = ops.KERNELS["sparse_relax"].launches - before
    Dp = sp.sparse_apsp_sources(g, hubs, backend="torch", stats=st)
    assert torch.equal(Dk, Dp) and sc == st and launches == sc["bf_rounds"]


@pytest.mark.cuda
def test_cuda_sparse_apsp_fixed_point_bitwise(cuda):
    rng = _rng(11)
    g = _random_csr(rng, 3000, 9000, cuda)
    src = torch.from_numpy(rng.choice(3000, 40, replace=False)).to(cuda)
    sc, st = {}, {}
    before = ops.KERNELS["sparse_relax"].launches
    Dk = sp.sparse_apsp_sources(g, src, backend="cuda", stats=sc)
    Dp = sp.sparse_apsp_sources(g, src, backend="torch", stats=st)
    assert torch.equal(Dk, Dp) and sc == st
    assert ops.KERNELS["sparse_relax"].launches == before + sc["bf_rounds"]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(1, 1), (13, 40), (40, 600), (7, 5000)])
def test_cuda_masked_argmax_bitwise(cuda, m, n):
    rng = _rng(m * n)
    S = torch.from_numpy(rng.integers(0, 4, (m, n)).astype(np.float32))
    mask = torch.from_numpy(rng.random(n) < 0.5)
    for msk in (mask, torch.ones(n, dtype=torch.bool)):
        S_d, m_d = S.to(cuda), msk.to(cuda)
        vk, ik = ops.masked_argmax(S_d, m_d, backend="cuda")
        vp, ip = ref.masked_argmax_ref(S_d, m_d)
        torch.cuda.synchronize()
        assert torch.equal(vk, vp) and torch.equal(ik, ip)


@pytest.mark.cuda
def test_cuda_cluster_backends_agree_bitwise(cuda):
    """The whole pipeline through the kernels equals the plain path on
    the card, given one S, and launches every kernel."""
    X, _ = make_dataset(300, 46, 5, noise=0.5, seed=3)
    S = ops.pearson(torch.from_numpy(X).to(cuda), backend="torch")
    ops.reset_launch_counts()
    rc = cluster(S=S, k=5, config=PipelineConfig.opt(backend="cuda"))
    counts = ops.launch_counts()
    rt = cluster(S=S, k=5, config=PipelineConfig.opt(backend="torch"))
    np.testing.assert_array_equal(rc.linkage, rt.linkage)
    np.testing.assert_array_equal(rc.labels, rt.labels)
    assert counts["masked_argmax"] == 299 and counts["minplus"] >= 2


@pytest.mark.cuda
def test_cuda_approx_backends_agree_bitwise(cuda):
    """The approx path's sparse tail through the kernels (top-K from S is
    a sort; the relaxation, min-plus and masked argmax kernels) equals
    the plain path on the card, given one S."""
    X, _ = make_dataset(300, 46, 5, noise=0.5, seed=4)
    S = ops.pearson(torch.from_numpy(X).to(cuda), backend="torch")
    ops.reset_launch_counts()
    rc = cluster(S=S, k=5, config=PipelineConfig.approx(sim_k=32,
                                                        backend="cuda"),
                 collect_timings=True)
    counts = ops.launch_counts()
    rt = cluster(S=S, k=5, config=PipelineConfig.approx(sim_k=32,
                                                        backend="torch"))
    np.testing.assert_array_equal(rc.linkage, rt.linkage)
    np.testing.assert_array_equal(rc.labels, rt.labels)
    assert counts["sparse_relax"] == rc.timings["apsp_rounds"] > 0
    assert counts["masked_argmax"] > 0 and counts["minplus"] > 0


@pytest.mark.cuda
def test_cuda_sparse_tmfg_at_full_k_is_the_dense_build(cuda):
    """From X at K = n-1 the top-K kernel's table holds the Pearson
    kernel's values, so the sparse TMFG is bitwise the dense OPT one."""
    from repro_torch.approx import knn, sparse_tmfg
    from repro_torch.core import tmfg
    X, _ = make_dataset(400, 46, 5, noise=0.5, seed=5)
    Xd = torch.from_numpy(X).to(cuda)
    S = ops.pearson(Xd, backend="cuda")
    dense = tmfg.build_tmfg(S, topk=64)
    t, Z = knn.topk_pearson_and_z(Xd, 399, backend="cuda")
    sparse, w, c = sparse_tmfg.build_tmfg_sparse(t, Xn=Z)
    for f in dense._fields:
        assert torch.equal(getattr(dense, f), getattr(sparse, f)), f
    e = dense.edges.long()
    assert torch.equal(w, S[e[:, 0], e[:, 1]]) and c.pair_misses == 0


_FLASH_ROUTE = {"float32": "flash_attention",
                "bfloat16": "flash_attention_wgmma"}


def _bf16_ulp(x):
    """One bf16 ulp at the largest magnitude of x (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(float(x.float().abs().max()))) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Tq,Tk,H,KV,hd,causal,window", [
    (1, 16, 16, 2, 2, 8, True, 0),         # the JAX tests' shapes
    (2, 40, 40, 4, 2, 16, True, 0),
    (1, 33, 33, 8, 1, 16, False, 0),
    (2, 64, 64, 4, 4, 32, False, 0),
    (1, 48, 48, 4, 2, 16, True, 4),
    (1, 48, 48, 4, 2, 16, True, 16),
    (1, 48, 48, 4, 2, 16, True, 64),
    (1, 200, 200, 8, 2, 64, True, 0),      # the zoo's head dims, ragged T
    (2, 333, 333, 8, 8, 64, True, 100),
    (1, 1000, 1000, 12, 1, 128, True, 0),
    (1, 130, 130, 4, 2, 128, False, 0),
    (1, 300, 300, 8, 4, 256, True, 64),
    (1, 257, 257, 4, 4, 256, True, 0),
    (1, 70, 150, 4, 2, 24, False, 0),      # Tq != Tk, hd = 24
])
def test_cuda_flash_attention_matches_plain(cuda, B, Tq, Tk, H, KV, hd,
                                            causal, window, dtype):
    rng = _rng(Tq * 7 + hd)
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.normal(size=(B, Tq, H, hd)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, Tk, KV, hd)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, Tk, KV, hd)).astype(np.float32))
    q, k, v = (t.to(cuda, dt) for t in (q, k, v))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              backend="cuda")
    assert ops.launch_counts()[_FLASH_ROUTE[dtype]] == 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == q.shape
    tol = 1e-5 if dtype == "float32" else _bf16_ulp(want)
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Tq,Tk,H,KV,hd,causal,window", [
    (1, 1024, 1024, 32, 8, 128, True, 0),   # granite-3-8b's fp32 prefill
    (1, 1000, 1000, 48, 1, 128, True, 0),   # G = 48 (MQA), ragged T
    (2, 333, 333, 96, 2, 64, True, 0),      # G = 48 at hd 64
    (1, 500, 500, 48, 1, 256, True, 64),    # G = 48 at hd 256, window
    (1, 300, 300, 6, 2, 72, True, 0),       # G = 3: one head per block
    (1, 200, 450, 8, 2, 128, False, 100),   # Tq < Tk, non-causal window
])
def test_cuda_flash_fp32_at_prefill_shapes(cuda, B, Tq, Tk, H, KV, hd, causal,
                                          window):
    """The fp32 kernel at the fp32 prefill path's shape and at GQA group
    sizes that take two heads per block (G even) or one (G odd): one
    launch, within 1e-5 of the plain version, every output finite."""
    rng = _rng(Tq + H + hd)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(cuda) for s in ((B, Tq, H, hd), (B, Tk, KV, hd),
                                   (B, Tk, KV, hd)))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              backend="cuda")
    assert ops.launch_counts()["flash_attention"] == 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    if window:
        # rows past Tk + window - 1 have no live key: held finite only
        live = torch.arange(Tq, device=cuda) < Tk - 1 + window
        got, want = got[:, live], want[:, live]
    assert float((got - want).abs().max()) <= 1e-5


def _bf16_qkv(cuda, seed, B, Tq, Tk, H, KV, hd):
    rng = _rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 .to(cuda, torch.bfloat16)
                 for s in ((B, Tq, H, hd), (B, Tk, KV, hd), (B, Tk, KV, hd)))


def _check_wgmma(q, k, v, causal, window, scale):
    """One launch of the wgmma kernel; every output finite, and the rows
    with a live key (all but the rows t >= Tk + window - 1 of a window)
    within one bf16 ulp of the plain version."""
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              scale=scale, backend="cuda")
    counts = ops.launch_counts()
    assert counts["flash_attention_wgmma"] == 1
    assert counts["flash_attention"] == 0
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bool(torch.isfinite(got.float()).all())
    Tq, Tk = q.shape[1], k.shape[1]
    if window:
        live = torch.arange(Tq, device=q.device) < Tk - 1 + window
        got, want = got[:, live], want[:, live]
    err = float((got.float() - want.float()).abs().max())
    assert err <= _bf16_ulp(want), (err, _bf16_ulp(want))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Tq,Tk,H,KV,hd,causal,window,prescaled", [
    (1, 131, 131, 8, 8, 64, True, 0, False),     # G = 1, ragged T
    (2, 200, 317, 8, 2, 72, True, 0, False),     # Tq < Tk, G = 4, hd 72, B 2
    (1, 300, 200, 8, 2, 64, True, 0, True),      # Tq > Tk
    (1, 390, 250, 16, 2, 128, False, 0, False),  # non-causal, G = 8
    (1, 300, 300, 8, 1, 128, True, 1, False),    # MQA, window 1
    (1, 333, 333, 4, 4, 256, True, 64, True),    # window 64, hd 256
    (1, 1500, 1500, 4, 1, 128, True, 1024, False),   # window 1024, MQA
    (2, 257, 257, 8, 2, 256, True, 1024, True),
    (1, 100, 300, 4, 2, 64, True, 64, False),    # Tq < Tk, windowed
    (1, 200, 200, 4, 2, 128, False, 32, True),   # non-causal, windowed
    (1, 77, 77, 2, 1, 8, True, 0, False),        # hd 8
    (1, 260, 260, 4, 4, 136, True, 0, True),     # hd 136 (padded to 192)
    (1, 4096, 4096, 4, 1, 128, True, 0, True),   # granite's T, causal
    # more (batch * head, 128-query) items than the H100's 132 SMs, so
    # each persistent block walks several with varied K/V tile counts
    (2, 1337, 1337, 8, 2, 128, True, 0, False),      # 176 items, ragged T
    (2, 1100, 1100, 8, 4, 64, True, 64, True),       # 144 items, window 64
    # 160 items, with whole query tiles past Tk + window - 1: no K/V tile
    (1, 1200, 300, 16, 4, 128, True, 100, False),
    (1, 1200, 300, 16, 4, 72, False, 100, True),     # non-causal
    (1, 900, 200, 20, 4, 256, True, 64, False),      # hd 256, BK 64
    # the serving zoo's prefill shapes, in the model's form (q scaled in
    # bf16, scale 1): zamba2's shared block (hd 80, padded to 128, window
    # 4096 past T), seamless's encoder (non-causal, hd 64), deepseek (MHA)
    # and qwen2-vl (GQA 64/8)
    (1, 2048, 2048, 32, 32, 80, True, 4096, True),
    (1, 1024, 1024, 16, 16, 64, False, 0, True),
    (1, 4096, 4096, 16, 16, 128, True, 0, True),
    (1, 1024, 1024, 64, 8, 128, True, 0, True),
])
def test_cuda_flash_wgmma_matches_plain(cuda, B, Tq, Tk, H, KV, hd, causal,
                                        window, prescaled):
    """The bf16 wgmma kernel within one bf16 ulp of the plain version's
    largest magnitude, in both scale forms: the Pallas one (the scores
    times 1 / sqrt(hd)) and the model's (q scaled in bf16, scale = 1).
    A row past Tk + window - 1 has no live key and its output is no
    defined attention: it is only held finite."""
    q, k, v = _bf16_qkv(cuda, Tq * 7 + Tk + hd, B, Tq, Tk, H, KV, hd)
    scale = None
    if prescaled:
        q = q * torch.tensor(hd ** -0.5, dtype=torch.bfloat16, device=cuda)
        scale = 1.0
    _check_wgmma(q, k, v, causal, window, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,KV,hd,causal,window", [
    (1, 200, 8, 2, 64, True, 70),       # GQA 4, window, ragged tiles
    (2, 130, 4, 4, 80, False, 0),       # MHA, bidirectional, hd 80
    (1, 150, 4, 1, 256, True, 0),       # MQA at hd 256 (32-key tiles)
    (1, 100, 6, 2, 128, True, 30),      # G = 3, a window under a tile
    (1, 512, 32, 8, 128, True, 0),      # granite-3-8b's heads and hd
])
def test_cuda_flash_backward_matches_plain(cuda, B, T, H, KV, hd, causal,
                                           window, dtype):
    """The backward kernels against the plain backward on the same
    inputs, each launch counted once on its route (bf16: the bf16
    forward for the lse, then the wgmma dq and dkdv, the wide ones above
    hd 128; fp32: the fp32 forward for the lse, then the split-TF32 dq
    and dkdv): fp32 within 1e-5 of each gradient's
    largest magnitude (another summation order), bf16 within 2^-7 of it
    (the gradients are rounded to bf16 once, from fp32 sums; the wgmma
    route also rounds P and dS to bf16); a second run bitwise the first
    (no atomics); and the same gradients through ``ops.flash_attention``'s
    autograd (which hands the backward the forward's own lse)."""
    from repro_torch.kernels.flash_attention import (
        bwd_route, flash_attention_bwd_cuda)
    rng = _rng(T + hd + H)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   .to(cuda, dt) for s in ((B, T, H, hd), (B, T, KV, hd),
                                           (B, T, KV, hd), (B, T, H, hd)))
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    ops.reset_launch_counts()
    got = flash_attention_bwd_cuda(q, k, v, o, do, causal=causal,
                                   window=window)
    counts = ops.launch_counts()
    pre = {"wgmma": "wgmma", "wgmma_wide": "wide",
           "tf32x3": "tf32x3"}[bwd_route(dt, hd)]
    want_counts = {_FLASH_ROUTE[dtype]: 1,
                   f"flash_attention_bwd_{pre}_dq": 1,
                   f"flash_attention_bwd_{pre}_dkdv": 1}
    assert counts == {**{n: 0 for n in counts}, **want_counts}, counts
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                       window=window)
    again = flash_attention_bwd_cuda(q, k, v, o, do, causal=causal,
                                     window=window)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(
        ops.flash_attention(*leaves, causal=causal, window=window), leaves,
        do)
    torch.cuda.synchronize()
    rel = 1e-5 if dtype == "float32" else 2.0 ** -7
    for g, w, a, b in zip(got, want, again, auto):
        assert g.dtype == dt and g.shape == w.shape
        assert torch.equal(g, a) and torch.equal(g, b)
        err = float((g.float() - w.float()).abs().max())
        assert err <= rel * float(w.float().abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,KV,hd,causal,window", [
    (1, 200, 8, 2, 64, True, 70),       # GQA 4, window, ragged tiles
    (2, 130, 4, 4, 80, False, 0),       # MHA, bidirectional, hd 80
    (1, 150, 4, 1, 256, True, 0),       # MQA at hd 256 (32-key tiles)
    (1, 100, 6, 2, 128, True, 30),      # G = 3, a window under a tile
    (1, 512, 32, 8, 128, True, 0),      # granite-3-8b's heads and hd
])
def test_cuda_flash_backward_cuda_core_matches_plain(cuda, B, T, H, KV, hd,
                                                     causal, window):
    """The CUDA-core backward (csrc/flash_attention_bwd.cu), on no route
    and run only when forced (``route="cuda_core"``, the old side of the
    A/B on the card), in fp32 against the plain backward on the same
    inputs: within 1e-5 of each gradient's largest magnitude; its three
    launches (rows, dkdv, dq) counted once each; a second run bitwise the
    first."""
    from repro_torch.kernels.flash_attention import bwd_launches
    rng = _rng(T + hd + H)
    q, k, v, do = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   .to(cuda) for s in ((B, T, H, hd), (B, T, KV, hd),
                                       (B, T, KV, hd), (B, T, H, hd)))
    kw = dict(causal=causal, window=window)
    o = ops.flash_attention(q, k, v, **kw)
    runs = []
    for _ in range(2):
        ops.reset_launch_counts()
        got, launches = bwd_launches(q, k, v, o, do, route="cuda_core", **kw)
        for _, launch in launches:
            launch()
        counts = ops.launch_counts()
        assert counts == {**{n: 0 for n in counts},
                          **{f"flash_attention_bwd_{n}": 1
                             for n in ("rows", "dkdv", "dq")}}, counts
        runs.append(got)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    for g, a, w in zip(*runs, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(g, a)
        err = float((g - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("B,Tq,Tk,H,KV,hd,causal,window", [
    (1, 333, 333, 8, 4, 256, True, 0),       # ragged T
    (2, 200, 200, 4, 1, 136, True, 0),       # MQA, hd 136 (HDP 192)
    (1, 150, 150, 4, 1, 256, True, 100),     # MQA, window under T
    (1, 256, 256, 8, 4, 256, True, 1),       # window 1: the diagonal
    (1, 100, 300, 8, 2, 192, False, 0),      # Tq < Tk, bidirectional
    (1, 100, 300, 8, 2, 248, True, 40),      # Tq < Tk, causal, window
    (2, 130, 130, 4, 4, 200, False, 0),      # non-causal, MHA, hd 200
    (1, 4096, 4096, 8, 4, 256, True, 1024),  # gemma3-4b local layer
    (1, 4096, 4096, 8, 4, 256, True, 0),     # gemma3-4b global layer
])
def test_cuda_flash_backward_wide_matches_plain(cuda, B, Tq, Tk, H, KV, hd,
                                                causal, window):
    """The bf16 backward above hd 128 (csrc/flash_attention_bwd_wgmma_wide.cu)
    on the forward's saved lse, against the plain backward on the same
    inputs: within 2^-7 of each gradient's largest magnitude, cosine >=
    0.9999; its two launches counted once each; a second run bitwise the
    first.  At T <= 333 also against the CPU twin of its schedule
    (``flash_bwd_wide_plan_ref``), which rounds P and dS where it does,
    within the same gate.  Window 1: each row's one live key is its own,
    so P = 1, o = v and dS = dP - D vanishes; dq and dk are then the
    fp32 rounding of that difference on both sides (about 1e-5) and are
    held to 1e-4 absolute, against O(0.1) for a wrong mask; dv = dO
    summed over the group is held to the gate."""
    from repro_torch.kernels import flash_attention as fa
    rng = _rng(Tq + Tk + hd + H)
    q, do = (torch.from_numpy(rng.normal(size=(B, Tq, H, hd))
                              .astype(np.float32)).to(cuda, torch.bfloat16)
             for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(B, Tk, KV, hd))
                             .astype(np.float32)).to(cuda, torch.bfloat16)
            for _ in range(2))
    kw = dict(causal=causal, window=window)
    assert fa.bwd_route(torch.bfloat16, hd) == "wgmma_wide"
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    ops.reset_launch_counts()
    got = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse=lse, **kw)
    counts = ops.launch_counts()
    assert counts == {**{n: 0 for n in counts},
                      "flash_attention_bwd_wide_dq": 1,
                      "flash_attention_bwd_wide_dkdv": 1}, counts
    again = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse=lse, **kw)
    wants = [ref.flash_attention_bwd_ref(q, k, v, o, do, **kw)]
    if max(Tq, Tk) <= 333:
        cpu = [t.cpu() for t in (q, k, v, o, do)]
        wants.append(fa.flash_bwd_wide_plan_ref(*cpu, lse=lse.cpu(), **kw))
    torch.cuda.synchronize()
    for want in wants:
        for name, g, a, w in zip("qkv", got, again, want):
            assert g.dtype == torch.bfloat16 and g.shape == w.shape
            assert torch.equal(g, a)
            g, w = g.double().cpu().flatten(), w.double().cpu().flatten()
            if window == 1 and name != "v":
                assert float(g.abs().max()) <= 1e-4
                assert float(w.abs().max()) <= 1e-4
                continue
            err = float((g - w).abs().max())
            assert err <= 2.0 ** -7 * float(w.abs().max()), err
            assert float(g @ w / (g.norm() * w.norm())) >= 0.9999


def _plain_lse(q, k, causal, window):
    """torch.logsumexp of the plain masked scaled scores, (B, H, Tq);
    -inf on a row with no live key."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    qh = q.reshape(B, Tq, KV, H // KV, hd).float() / hd ** 0.5
    s = torch.einsum("bqKgh,bsKh->bKgqs", qh, k.float())
    ti = torch.arange(Tq, device=q.device)[:, None]
    tj = torch.arange(Tk, device=q.device)[None, :]
    live = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        live &= tj <= ti
    if window > 0:
        live &= ti - tj < window
    return torch.logsumexp(torch.where(live, s, float("-inf")), -1) \
        .reshape(B, H, Tq)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Tq,Tk,H,KV,hd,causal,window", [
    (1, 4096, 4096, 32, 8, 128, True, 0),     # granite-3-8b's prefill
    (2, 333, 333, 8, 2, 64, True, 100),
    (1, 200, 200, 4, 4, 80, False, 0),
    (1, 300, 300, 8, 4, 256, True, 64),       # 64-key tiles
])
def test_cuda_flash_wgmma_lse_output_leaves_o_bitwise(cuda, B, Tq, Tk, H,
                                                      KV, hd, causal,
                                                      window):
    """The bf16 forward's o is the same bit for bit with the lse output
    on and off, and the launch is counted once either way."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q, k, v = _bf16_qkv(cuda, Tq + hd, B, Tq, Tk, H, KV, hd)
    ops.reset_launch_counts()
    o = flash_attention_cuda(q, k, v, causal=causal, window=window)
    o2, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_wgmma"] == 2
    assert torch.equal(o, o2) and lse.dtype == torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize("B,Tq,Tk,H,KV,hd,causal,window", [
    (1, 1000, 1000, 8, 2, 128, True, 0),
    (2, 333, 333, 8, 2, 64, True, 100),
    (1, 200, 200, 4, 4, 80, False, 0),
    (1, 300, 300, 8, 4, 256, True, 64),
    (1, 150, 60, 4, 2, 64, True, 20),        # rows past 78 see no key
    (1, 150, 60, 4, 2, 256, True, 20),       # the same, wide backward
])
def test_cuda_flash_wgmma_saved_lse_matches_logsumexp(cuda, B, Tq, Tk, H,
                                                      KV, hd, causal,
                                                      window):
    """The lse the bf16 forward saves, (B, H, Tq rounded up to 64), within
    1e-5 * max(1, |lse|) of torch.logsumexp of the plain masked scores;
    +inf on the padding and on rows with no live key, whose gradients
    from a wgmma backward are then zero (their dq rows, and dk, dv
    the same as with their dO rows zeroed)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda, lse_rows)
    q, k, v = _bf16_qkv(cuda, Tq + Tk + hd, B, Tq, Tk, H, KV, hd)
    o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                  return_lse=True)
    want = _plain_lse(q, k, causal, window)
    torch.cuda.synchronize()
    assert lse.shape == (B, H, lse_rows(Tq))
    got, pad = lse[..., :Tq], lse[..., Tq:]
    live = torch.isfinite(want)
    err = ((got - want).abs() / want.abs().clamp_min(1))[live]
    assert float(err.max()) <= 1e-5, float(err.max())
    assert bool((got[~live] == float("inf")).all())
    assert bool((pad == float("inf")).all())
    if bool(live.all()):
        return
    dead = ~live[0, 0]
    do = torch.randn(o.shape, device=cuda).bfloat16()
    kw = dict(causal=causal, window=window, lse=lse)
    dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, do, **kw)
    do0 = torch.where(dead[None, :, None, None], 0.0, do.float()).bfloat16()
    _, dk0, dv0 = flash_attention_bwd_cuda(q, k, v, o, do0, **kw)
    torch.cuda.synchronize()
    assert not bool(dq[:, dead].any())
    assert torch.equal(dk, dk0) and torch.equal(dv, dv0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Tq,Tk,H,KV,hd,causal,window", [
    (1, 4096, 4096, 32, 8, 128, True, 0),     # granite-3-8b, hd = HDP
    (1, 333, 333, 4, 1, 128, True, 0),        # MQA, G = 4 over 333 rows
    (2, 200, 200, 8, 2, 64, True, 70),        # hd = HDP 64, a window
    (2, 130, 130, 4, 4, 80, False, 0),        # hd 80 in HDP 128
    (1, 257, 257, 6, 3, 40, False, 0),        # hd 40 in HDP 64, G = 2
    (1, 300, 300, 8, 4, 256, True, 64),       # hd 256: hd in two parts
    (2, 200, 200, 4, 1, 136, True, 0),        # hd 136 in HDP 256
    (1, 100, 300, 8, 2, 192, False, 0),       # Tq < Tk, bidirectional
    (1, 150, 60, 4, 2, 64, True, 20),         # rows past 78 see no key
])
def test_cuda_flash_backward_tf32x3_matches_plain(cuda, B, Tq, Tk, H, KV,
                                                  hd, causal, window):
    """The fp32 backward on the tensor cores
    (csrc/flash_attention_bwd_tf32x3.cu) on the fp32 forward's saved lse,
    against the plain backward on the same inputs: within 1e-5 of each
    gradient's largest magnitude (the split keeps about 22 bits a
    product), its two launches counted once each, a second run bitwise
    the first; rows with no live key get zero dq, and dk, dv as with
    their dO rows zeroed (the plain backward spreads them uniformly, so
    that case is held to its own answer)."""
    from repro_torch.kernels import flash_attention as fa
    rng = _rng(Tq + Tk + hd + H + 7)
    q, do = (torch.from_numpy(rng.normal(size=(B, Tq, H, hd))
                              .astype(np.float32)).to(cuda)
             for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(B, Tk, KV, hd))
                             .astype(np.float32)).to(cuda)
            for _ in range(2))
    kw = dict(causal=causal, window=window)
    assert fa.bwd_route(torch.float32, hd) == "tf32x3"
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    ops.reset_launch_counts()
    got = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse=lse, **kw)
    counts = ops.launch_counts()
    assert counts == {**{n: 0 for n in counts},
                      "flash_attention_bwd_tf32x3_dq": 1,
                      "flash_attention_bwd_tf32x3_dkdv": 1}, counts
    again = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse=lse, **kw)
    dead = torch.isinf(lse[0, 0, :Tq])
    do_live = torch.where(dead[None, :, None, None], 0.0, do)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do_live, **kw)
    torch.cuda.synchronize()
    for name, g, a, w in zip("qkv", got, again, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(g, a)
        if name == "q":
            assert not bool(g[:, dead].any())
            g, w = g[:, ~dead], w[:, ~dead]
        err = float((g - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Tq,Tk,H,KV,hd,causal,window", [
    (1, 4096, 4096, 32, 8, 128, True, 0),     # granite-3-8b's training
    (1, 1000, 1000, 48, 1, 128, True, 0),     # MQA: one head a block
    (2, 333, 333, 8, 2, 64, True, 100),
    (1, 200, 200, 4, 4, 80, False, 0),
    (1, 300, 300, 8, 4, 256, True, 64),       # flash_kernel_wide
    (1, 150, 60, 4, 2, 64, True, 20),         # rows past 78 see no key
    (1, 150, 60, 4, 2, 256, True, 20),
])
def test_cuda_flash_fp32_lse_leaves_o_bitwise_and_matches_logsumexp(
        cuda, B, Tq, Tk, H, KV, hd, causal, window):
    """The fp32 forward's o is the same bit for bit with its lse output on
    and off, and that lse, (B, H, Tq rounded up to 64), is within 1e-5 *
    max(1, |lse|) of torch.logsumexp of the plain masked scores, +inf on
    the padding and on rows with no live key."""
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     lse_rows)
    rng = _rng(Tq + Tk + hd + 3)
    q = torch.from_numpy(rng.normal(size=(B, Tq, H, hd))
                         .astype(np.float32)).to(cuda)
    k, v = (torch.from_numpy(rng.normal(size=(B, Tk, KV, hd))
                             .astype(np.float32)).to(cuda)
            for _ in range(2))
    ops.reset_launch_counts()
    o = flash_attention_cuda(q, k, v, causal=causal, window=window)
    o2, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    want = _plain_lse(q, k, causal, window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 2
    assert torch.equal(o, o2)
    assert lse.shape == (B, H, lse_rows(Tq)) and lse.dtype == torch.float32
    got, pad = lse[..., :Tq], lse[..., Tq:]
    live = torch.isfinite(want)
    err = ((got - want).abs() / want.abs().clamp_min(1))[live]
    assert float(err.max()) <= 1e-5, float(err.max())
    assert bool((got[~live] == float("inf")).all())
    assert bool((pad == float("inf")).all())


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("tie", ["equal_keys", "zero_queries"])
def test_cuda_flash_wgmma_exact_ties(cuda, hd, tie):
    """Scores that tie exactly: every key the same (or every query zero),
    so each row's softmax is uniform over its live keys."""
    q, k, v = _bf16_qkv(cuda, hd, 2, 333, 333, 8, 2, hd)
    if tie == "equal_keys":
        k = k[:, :1].expand_as(k).contiguous()
    else:
        q = torch.zeros_like(q)
    for causal, window in ((True, 0), (True, 100), (False, 0)):
        _check_wgmma(q, k, v, causal, window, None)


@pytest.mark.cuda
def test_cuda_flash_routes_by_dtype(cuda):
    """bf16 launches the wgmma kernel once and the CUDA-core kernel never;
    fp32 the other way round."""
    q, k, v = _bf16_qkv(cuda, 5, 1, 64, 64, 4, 2, 64)
    for dt, route in ((torch.bfloat16, "flash_attention_wgmma"),
                      (torch.float32, "flash_attention")):
        ops.reset_launch_counts()
        ops.flash_attention(q.to(dt), k.to(dt), v.to(dt), backend="cuda")
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert counts == {**{n: 0 for n in counts}, route: 1}, counts


@pytest.mark.cuda
def test_cuda_prefill_goes_through_the_kernel(cuda):
    """DecoderModel.prefill on the card launches the flash kernel once per
    layer and agrees with backend='torch' within 1e-4 (fp32)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = get_config("gemma3-4b").reduced(n_layers=7)
    model = build_model(cfg)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    params = model.init(gen)
    toks = torch.from_numpy(_rng(1).integers(0, cfg.vocab, (2, 40))).to(cuda)
    ops.reset_launch_counts()
    lc, caches, pos = model.prefill(params, toks, max_len=64)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    lt, _, _ = model.prefill(params, toks, max_len=64, backend="torch")
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    assert float((lc - lt).abs().max()) <= 1e-4
    assert pos == 40 and len(caches) == cfg.n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("arch,flash_per_prefill", [
    ("deepseek-moe-16b", 4), ("mixtral-8x7b", 4), ("qwen2-vl-72b", 4),
    ("zamba2-2.7b", 2), ("xlstm-125m", 0), ("seamless-m4t-large-v2", 6)])
def test_cuda_zoo_prefill_goes_through_the_kernel(cuda, arch,
                                                  flash_per_prefill):
    """Each family's prefill on the card (reduced, fp32) launches the
    fp32 flash kernel once per attention (zamba2: once per shared-block
    group of two Mamba2 layers; seamless: its 2 encoder layers non-causal
    and 4 decoder layers causal; xLSTM: never) and no other kernel, and agrees with
    backend='torch' within 1e-4; two batched decode steps stay finite."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    params = model.init(gen)
    rng = _rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40))).to(cuda)
    fe = None
    if cfg.frontend != "none":
        fe = torch.from_numpy(rng.normal(
            size=(2, cfg.frontend_len, cfg.d_model)).astype(np.float32)) \
            .to(cuda)
    ops.reset_launch_counts()
    lc, caches, pos = model.prefill(params, toks, fe, max_len=64)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == flash_per_prefill
    assert sum(counts.values()) == flash_per_prefill, counts
    lt, _, _ = model.prefill(params, toks, fe, max_len=64, backend="torch")
    assert float((lc - lt).abs().max()) <= 1e-4
    for _ in range(2):
        tok = torch.argmax(lc, -1)
        lc, caches = model.decode_step(params, caches, tok, pos)
        assert bool(torch.isfinite(lc).all())
        pos += 1


# ---------------------------------------------------------------------------
# the TMFG builders' device loops
# ---------------------------------------------------------------------------

def _tmfg_sources(cuda, kind):
    """A lazy-loop value source of each kind at n = 300 on the card."""
    from repro_torch.approx import knn, sparse_tmfg
    from repro_torch.core import tmfg

    X, _ = make_dataset(300, 46, 5, noise=0.6, seed=9)
    Xd = torch.from_numpy(X).to(cuda)
    if kind == "table-Z":
        table, Z = knn.topk_pearson_and_z(Xd, 32, backend="cuda")
        return sparse_tmfg._TableSource(table.values, table.indices, Z,
                                        True)
    S = tmfg.prepare_similarity(ops.pearson(Xd, backend="cuda"))
    topk = 64 if kind == "dense-64" else 0
    return tmfg._Device(S, tmfg.candidate_table(S, topk) if topk else None)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense-0", "dense-64", "table-Z"])
def test_cuda_lazy_graph_equals_eager_steps(cuda, kind):
    """The lazy loop as a program (T steps captured in a CUDA graph,
    replayed) is bitwise the same step run eagerly on the card, within
    ceil(pops / T) + 3 host syncs."""
    import math

    from repro_torch.core import tmfg

    prog = tmfg.LoopProgram(_tmfg_sources(cuda, kind), tmfg.STEPS_PER_SYNC)
    got, syncs, w, c = prog.run()
    assert prog.graph is not None
    want, _, w0, c0 = tmfg.lazy_build(_tmfg_sources(cuda, kind))
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(w, w0) and c == c0
    assert syncs <= math.ceil(int(got.pops) / tmfg.STEPS_PER_SYNC) + 3


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense-64", "table-Z"])
def test_cuda_cached_loop_program_equals_uncached_build(cuda, kind):
    """The cached loop program (buffers and CUDA graph reused across
    builds) is bitwise the uncached build (a fresh state, eager steps) at
    n = 2000, on its first run and on a replay with other inputs, and
    the replay builds nothing."""
    from repro_torch.approx import knn, sparse_tmfg
    from repro_torch.core import tmfg
    from repro_torch.obs import trace as obs_trace

    def run(seed):
        X, _ = make_dataset(2000, 46, 8, noise=0.6, seed=seed)
        Xd = torch.from_numpy(X).to(cuda)
        if kind == "table-Z":
            table, Z = knn.topk_pearson_and_z(Xd, 32, backend="cuda")
            got, w, c = sparse_tmfg.sparse_lazy_tmfg(
                table.values, table.indices, Z, from_x=True)
            want, _, w0, c0 = tmfg.lazy_build(sparse_tmfg._TableSource(
                table.values, table.indices, Z, True))
            assert torch.equal(w, w0) and c == c0
            return got, want
        S = ops.pearson(Xd, backend="cuda")
        got, _ = tmfg._build(S, "lazy", topk=64)
        Sp = tmfg.prepare_similarity(S)
        want, _, _, _ = tmfg.lazy_build(
            tmfg._Device(Sp, tmfg.candidate_table(Sp, 64)))
        return got, want

    for seed in (21, 22):
        with obs_trace.watch_recompiles() as w:
            got, want = run(seed)
        if seed == 22:
            assert w.count == 0
        for f in want._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), (seed, f)


@pytest.mark.cuda
@pytest.mark.parametrize("method,prefix", [("corr", 10), ("orig", 10)])
def test_cuda_corr_and_orig_through_the_kernel(cuda, method, prefix):
    """CORR's per-step scan and ORIG's face rows through the masked
    argmax kernel equal the plain version's build."""
    from repro_torch.core import build_tmfg

    X, _ = make_dataset(200, 46, 5, noise=0.6, seed=10)
    S = ops.pearson(torch.from_numpy(X).to(cuda), backend="torch")
    before = ops.KERNELS["masked_argmax"].launches
    got = build_tmfg(S, method=method, prefix=prefix, backend="cuda")
    launched = ops.KERNELS["masked_argmax"].launches - before
    want = build_tmfg(S, method=method, prefix=prefix, backend="torch")
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert launched >= (197 if method == "corr" else int(got.pops))


@pytest.mark.cuda
def test_cuda_masked_argmax_on_all_neg_inf_rows(cuda):
    """Rows whose unmasked entries are all -inf give the plain version's
    index, the lowest column (CORR's scan once nothing is left)."""
    rng = _rng(12)
    n = 9
    S = torch.from_numpy(rng.normal(size=(n, n)).astype(np.float32))
    S.fill_diagonal_(float("-inf"))
    for free in ([5], [], [0], [3, 7]):
        mask = torch.ones(n, dtype=torch.bool)
        mask[free] = False
        S_d, m_d = S.to(cuda), mask.to(cuda)
        vk, ik = ops.masked_argmax(S_d, m_d, backend="cuda")
        vp, ip = ref.masked_argmax_ref(S_d, m_d)
        assert torch.equal(vk, vp) and torch.equal(ik, ip)


@pytest.mark.cuda
def test_cuda_dbht_sparse_backends_agree_bitwise(cuda):
    """The staged sparse tail through the relaxation, min-plus and
    masked-argmax kernels equals the plain path on the card, given one S
    and TMFG: device and host impls, and the tree mode above hac_max."""
    from repro_torch.core import build_tmfg, sparse_dbht
    X, _ = make_dataset(500, 46, 5, noise=0.5, seed=6)
    S = ops.pearson(torch.from_numpy(X).to(cuda), backend="torch")
    tm = build_tmfg(S, topk=64)
    fields = ("linkage", "cluster_of", "bubble_of", "converging",
              "direction", "apsp")
    for kw in ({}, {"impl": "host"}, {"hac_max": 64}):
        ops.reset_launch_counts()
        stats = {}
        rc = sparse_dbht.dbht_sparse(S, tm, backend="cuda", stats=stats, **kw)
        counts = ops.launch_counts()
        rt = sparse_dbht.dbht_sparse(S, tm, backend="torch", **kw)
        for f in fields:
            assert torch.equal(getattr(rc, f), getattr(rt, f)), (kw, f)
        assert counts["sparse_relax"] == stats["bf_rounds"] > 0
        assert counts["minplus"] >= 1 and counts["masked_argmax"] > 0
    if rc.hubs is not None:
        assert torch.equal(rc.hubs, rt.hubs)


@pytest.mark.cuda
@pytest.mark.parametrize("apsp_method", ["hub", "sparse"])
def test_cuda_cluster_batch_backends_agree_bitwise(cuda, apsp_method):
    """Each ``cluster_batch`` entry on the card is the single ``cluster``
    of that entry, fused and staged, and the ``cuda`` backend is bitwise
    the ``torch`` backend on one S."""
    from repro_torch.core import cluster_batch
    Xb = np.stack([make_dataset(500, 46, 5, noise=0.5, seed=s)[0]
                   for s in range(2)])
    Sb = torch.stack([ops.pearson(torch.from_numpy(x).to(cuda),
                                  backend="torch") for x in Xb])
    cfg = PipelineConfig.opt(backend="cuda").replace(apsp_method=apsp_method)
    bt = cluster_batch(S=Sb, k=5, config=cfg.replace(backend="torch"))
    for fused in (True, False):
        bc = cluster_batch(S=Sb, k=5, config=cfg, fused=fused)
        for b in range(2):
            one = cluster(S=Sb[b], k=5, config=cfg, fused=fused)
            np.testing.assert_array_equal(bc[b].linkage, one.linkage)
            np.testing.assert_array_equal(bc[b].linkage, bt[b].linkage)
            np.testing.assert_array_equal(bc[b].labels, bt[b].labels)


@pytest.mark.cuda
@pytest.mark.parametrize("filt,ag_m", [("mst", 0), ("ag", 0), ("ag", 100)])
@pytest.mark.parametrize("apsp_method", ["exact", "hub", "sparse"])
def test_cuda_filters_backends_agree_bitwise(cuda, filt, ag_m, apsp_method):
    """Each filter's tail through the min-plus, relaxation and
    masked-argmax kernels equals the plain path on the card, given one S
    (n = 256: the hub path runs from 200 up); an AG of 100 edges
    shatters into components."""
    n = 256
    X, _ = make_dataset(n, 46, 4, noise=0.7, seed=8)
    S = ops.pearson(torch.from_numpy(X).to(cuda), backend="torch")
    cfg = PipelineConfig.opt(backend="cuda").replace(
        filter=filt, ag_m=ag_m, apsp_method=apsp_method)
    ops.reset_launch_counts()
    rc = cluster(S=S, k=4, config=cfg, collect_timings=True)
    counts = ops.launch_counts()
    rt = cluster(S=S, k=4, config=cfg.replace(backend="torch"))
    np.testing.assert_array_equal(rc.linkage, rt.linkage)
    np.testing.assert_array_equal(rc.labels, rt.labels)
    assert torch.equal(rc.tmfg.edges, rt.tmfg.edges)
    assert torch.equal(rc.dbht.apsp, rt.dbht.apsp)
    assert counts["masked_argmax"] == n - 1
    assert counts["minplus"] >= 1 and counts["pearson"] == 0
    assert counts["sparse_relax"] == int(rc.timings["apsp_rounds"])
    assert (counts["sparse_relax"] > 0) == (apsp_method != "exact")
    if ag_m:
        assert int(rc.dbht.converging.shape[0]) > 1


@pytest.mark.cuda
def test_cuda_candidate_pools_match_the_cpu_call(cuda):
    """One seed draws one R (a CPU generator) for the card and the CPU;
    the card's pools are bitwise a stable top-k of the Pearson kernel's
    rows of the card's sketch, and the CPU call's pools hold the same
    candidates but where the two sketches' last-bit roundings reorder a
    near-tie; rescoring on the card is the CPU's table."""
    from repro_torch.approx import knn, project
    from repro_torch.kernels.pearson import pearson_cuda
    n, pool, dim = 1000, 64, 32
    X, _ = make_dataset(n, 46, 5, noise=0.5, seed=9)
    Xc = torch.from_numpy(X).to(cuda)
    ops.reset_launch_counts()
    pc = project.candidate_pools(Xc, pool, dim=dim, seed=5)
    assert ops.launch_counts()["topk"] == 1
    pt = project.candidate_pools(torch.from_numpy(X), pool, dim=dim, seed=5)
    sk = project.sketch(Xc, dim=dim, seed=5)
    np.testing.assert_allclose(sk.cpu().numpy(), project.sketch(
        torch.from_numpy(X), dim=dim, seed=5).numpy(), rtol=0, atol=1e-5)
    P = pearson_cuda(sk)
    P.fill_diagonal_(float("-inf"))
    want = torch.sort(P, dim=1, descending=True, stable=True)[1][:, :pool]
    assert torch.equal(pc, want.int())
    same = sum(len(set(a) & set(b)) for a, b in zip(
        pc.cpu().numpy().tolist(), pt.numpy().tolist()))
    assert same >= 0.999 * n * pool
    rc = knn.rescore_pools(Xc, pc, 16)
    rt = knn.rescore_pools(torch.from_numpy(X), pc.cpu(), 16)
    np.testing.assert_allclose(rc.values.cpu().numpy(), rt.values.numpy(),
                               rtol=0, atol=1e-6)
