"""The port's streaming tier (``repro_torch.stream``) and its pipeline
hooks against the reference's, on the CPU.

  * the window state: ``buf``, ``head``, ``count`` and ``ref`` bitwise
    the reference's, ``s1`` and ``s2`` within 1e-6 of their largest
    magnitude, across fill, wrap, re-anchor and a high-mean /
    low-variance series; ``window_push_block`` bitwise sequential pushes;
  * ``window_similarity`` within 1e-6 of JAX's on JAX's state carried
    across, and within 1e-5 of the Pearson path on the materialized
    window;
  * ``content_key`` the reference's digest for the same S and config;
  * ``ClusterService`` over a stream of well-separated series: the
    reference service's labels, warm hits and cache hits;
  * ``MicroBatcher``: the reference's buckets, flush counts, pads and
    dedupe;
  * ``cluster(moments=...)`` fused and staged bitwise
    ``cluster(S=window_similarity(...))``; ``run_pipeline_device``'s
    outputs those of ``cluster``; two threads clustering at one n.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.config import PipelineConfig as JConfig  # noqa: E402
from repro.data.timeseries import make_dataset  # noqa: E402
from repro.stream import cache as jcache  # noqa: E402
from repro.stream import scheduler as jsched  # noqa: E402
from repro.stream import service as jservice  # noqa: E402
from repro.stream import window as jwin  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.config import PipelineConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.stream import cache as tcache  # noqa: E402
from repro_torch.stream import scheduler as tsched  # noqa: E402
from repro_torch.stream import service as tservice  # noqa: E402
from repro_torch.stream import window as twin  # noqa: E402

from conftest import clustered_similarity  # noqa: E402


def _ticks(n, T, seed=0, level=0.0, scale=1.0):
    """(n, T) random-walk ticks; ``level`` lifts every series (the
    price-like case: level much larger than the moves)."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(scale=scale, size=(n, T)).astype(np.float32)
    base = rng.normal(size=(n, 1)).astype(np.float32) + np.float32(level)
    return (base + np.cumsum(steps, axis=1)).astype(np.float32)


def _to_torch(js) -> twin.WindowState:
    """The reference's state as the port's (head and count on the host)."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))
    return twin.WindowState(
        buf=t(js.buf), head=torch.tensor(int(js.head), dtype=torch.int32),
        count=torch.tensor(int(js.count), dtype=torch.int32), ref=t(js.ref),
        s1=t(js.s1), c1=t(js.c1), s2=t(js.s2), c2=t(js.c2))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# fill only, exactly one pass (wrap + re-anchor), several passes, and the
# high-mean / low-variance series
WINDOW_CASES = [(12, 8, 5, 0.0, 1.0), (12, 8, 8, 0.0, 1.0),
                (10, 7, 23, 0.0, 1.0), (9, 6, 17, 1000.0, 1e-3)]


@pytest.mark.parametrize("n,L,T,level,scale", WINDOW_CASES)
def test_window_state_matches_reference(n, L, T, level, scale):
    X = _ticks(n, T, seed=n + T, level=level, scale=scale)
    js = jwin.window_init(n, L)
    ts = twin.window_init(n, L)
    for t in range(T):
        js = jwin.window_push(js, jnp.asarray(X[:, t]))
        ts = twin.window_push(ts, X[:, t])
        assert int(ts.head) == int(js.head)
        assert int(ts.count) == int(js.count)
    np.testing.assert_array_equal(ts.buf.numpy(), np.asarray(js.buf))
    np.testing.assert_array_equal(ts.ref.numpy(), np.asarray(js.ref))
    assert _rel(ts.s1.numpy(), js.s1) <= 1e-6
    assert _rel(ts.s2.numpy(), js.s2) <= 1e-6
    np.testing.assert_array_equal(twin.materialize(ts), jwin.materialize(js))


@pytest.mark.parametrize("n,L,T,level,scale", WINDOW_CASES[1:3])
def test_window_push_block_is_sequential_pushes(n, L, T, level, scale):
    X = _ticks(n, T, seed=3, level=level, scale=scale)
    seq = twin.window_init(n, L)
    for t in range(T):
        seq = twin.window_push(seq, X[:, t])
    blk = twin.window_push_block(twin.window_init(n, L), X[:, :3])
    blk = twin.window_push_block(blk, X[:, 3:])
    for a, b in zip(seq, blk):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,L,T,level,scale", WINDOW_CASES)
def test_window_similarity_on_reference_state(n, L, T, level, scale):
    X = _ticks(n, T, seed=1, level=level, scale=scale)
    js = jwin.window_push_block(jwin.window_init(n, L), jnp.asarray(X))
    got = twin.window_similarity(_to_torch(js)).numpy()
    want = np.asarray(jwin.window_similarity(js))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # and the port's own state against the Pearson path on its window
    ts = twin.window_push_block(twin.window_init(n, L), X)
    P = ops.pearson(torch.from_numpy(twin.materialize(ts).copy()))
    if level == 0.0:
        np.testing.assert_allclose(twin.window_similarity(ts).numpy(),
                                   P.numpy(), rtol=0, atol=1e-5)
    S_prev = torch.zeros(n, n)
    assert twin.window_delta(ts, S_prev) == pytest.approx(
        float(twin.window_similarity(ts).abs().mean()), abs=1e-7)


def test_content_key_is_the_reference_digest():
    S, _, _ = clustered_similarity(20, k=3, seed=2)
    S = S.astype(np.float32)
    for cfg_t, cfg_j, k in [(PipelineConfig.opt(), JConfig.opt(), 3),
                            (PipelineConfig.approx(sim_k=8),
                             JConfig.approx(sim_k=8), None)]:
        assert cfg_t.content_key() == cfg_j.content_key()
        key = (k,) + cfg_t.content_key()
        assert tcache.content_key(S, key) == jcache.content_key(S, key)
        assert tcache.content_key(torch.from_numpy(S), key) \
            == jcache.content_key(S, key)
    assert tsched.bucket_size(3, (1, 2, 4, 8)) == \
        jsched.bucket_size(3, (1, 2, 4, 8))


N_SVC, W_SVC = 32, 24


@pytest.fixture(scope="module")
def stream_pair():
    """The port's and the reference's service over one tick stream of
    well-separated series: each recluster's labels, and the services."""
    X, _ = make_dataset(N_SVC, W_SVC + 16, 4, noise=0.3, seed=11)
    X = X.astype(np.float32)
    kw = dict(n=N_SVC, window=W_SVC, k=4, max_batch=1, recluster_every=8)
    tsvc = tservice.ClusterService(**kw, device="cpu")
    jsvc = jservice.ClusterService(**kw)
    labels = []
    for t in range(X.shape[1]):
        rt, rj = tsvc.tick(X[:, t]), jsvc.tick(X[:, t])
        assert (rt is None) == (rj is None)
        if rt is not None:
            tsvc.drain()
            jsvc.drain()
            labels.append((rt.result.labels, rj.result.labels))
    return tsvc, jsvc, labels


def test_service_labels_match_reference(stream_pair):
    tsvc, jsvc, labels = stream_pair
    assert len(labels) == 3            # at ticks 24, 32, 40
    for got, want in labels:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(tsvc.similarity(), jsvc.similarity(),
                               rtol=0, atol=1e-5)


def test_service_warm_and_cache_hits_match_reference(stream_pair):
    tsvc, jsvc, _ = stream_pair
    S_old = clustered_similarity(N_SVC, k=4, seed=5)[0].astype(np.float32)
    for svc in (tsvc, jsvc):
        first = svc.submit(S=S_old)
        svc.drain()
        assert first.done
        again = svc.submit()           # the window, again: the warm tier
        assert again.done and again.cached
        old = svc.submit(S=S_old)      # an earlier window: the LRU
        assert old.done and old.cached
    for key in ("service_warm_hits", "service_batches_run",
                "service_cache_entries", "service_ticks"):
        assert tsvc.stats()[key] == jsvc.stats()[key], key
    assert (tsvc.cache.hits, tsvc.cache.misses) == \
        (jsvc.cache.hits, jsvc.cache.misses)
    assert tsvc.method == jsvc.method == "lazy"      # ConfigFields
    assert tsvc.healthz()["status"] == "ok"


def test_microbatcher_matches_reference():
    mats = [clustered_similarity(20, k=3, seed=s)[0].astype(np.float32)
            for s in range(3)]
    order = [0, 1, 0, 2, 1]
    out = {}
    for name, mod, cache_mod in (("torch", tsched, tcache),
                                 ("jax", jsched, jcache)):
        kw = dict(device="cpu") if name == "torch" else {}
        mb = mod.MicroBatcher(max_batch=4, cache=cache_mod.ResultCache(8),
                              **kw)
        reqs = [mb.submit(mats[i], k=3) for i in order]
        mb.flush()
        late = [mb.submit(mats[i], k=3) for i in (2, 1)]
        mb.flush()
        mb.flush()                     # empty: no flush counted
        out[name] = dict(
            counts=(mb.batches_run, mb.requests_run, mb.dedup_hits,
                    mb.flushes, mb.pad_slots, mb.batch_slots, mb.buckets),
            labels=[r.result.labels for r in reqs + late],
            cached=[r.cached for r in reqs + late])
    assert out["torch"]["counts"] == out["jax"]["counts"]
    assert out["torch"]["cached"] == out["jax"]["cached"]
    for a, b in zip(out["torch"]["labels"], out["jax"]["labels"]):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def window_state():
    X = _ticks(40, 30, seed=9)
    return twin.window_push_block(twin.window_init(40, 24), X)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("cfg", [PipelineConfig.opt(),
                                 PipelineConfig.approx(sim_k=12)],
                         ids=["opt", "approx"])
def test_cluster_moments_is_cluster_on_window_similarity(window_state, cfg,
                                                         fused):
    got = tcore.cluster(moments=window_state, k=4, config=cfg, fused=fused,
                        device="cpu")
    want = tcore.cluster(S=twin.window_similarity(window_state), k=4,
                         config=cfg, fused=fused, device="cpu")
    np.testing.assert_array_equal(got.linkage, want.linkage)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert torch.equal(got.tmfg.edges, want.tmfg.edges)


@pytest.mark.parametrize("cfg", [PipelineConfig.opt(),
                                 PipelineConfig.approx(sim_k=12),
                                 PipelineConfig.mst()],
                         ids=["opt", "approx", "mst"])
def test_run_pipeline_device_outputs_are_clusters(cfg):
    X, _ = make_dataset(40, 30, 4, noise=0.5, seed=3)
    want = tcore.cluster(X, k=4, config=cfg, device="cpu")
    out = tcore.run_pipeline_device(X, cfg, device="cpu")
    assert isinstance(out, tpipe.DeviceOutputs)
    np.testing.assert_array_equal(out.linkage.numpy(), want.linkage)
    assert torch.equal(out.tmfg.edges, want.tmfg.edges)
    assert torch.equal(out.cluster_of, want.dbht.cluster_of)
    assert torch.equal(torch.nonzero(out.conv_mask).reshape(-1),
                       want.dbht.converging.long())
    assert torch.equal(out.direction[1:], want.dbht.direction)
    # batched: a leading batch axis, entry b the single run
    Xb = np.stack([X, make_dataset(40, 30, 4, noise=0.5, seed=4)[0]])
    outb = tcore.run_pipeline_device(Xb, cfg, device="cpu")
    assert outb.linkage.shape == (2, 39, 4)
    np.testing.assert_array_equal(outb.linkage[0].numpy(), want.linkage)


def test_run_pipeline_device_refusals():
    S = clustered_similarity(16, k=2, seed=1)[0]
    with pytest.raises(ValueError, match="host"):
        tcore.run_pipeline_device(S, PipelineConfig(dbht_impl="host"),
                                  device="cpu")
    asym = np.arange(16 * 16, dtype=np.float32).reshape(16, 16)
    with pytest.raises(ValueError, match="ambiguous"):
        tcore.run_pipeline_device(asym, PipelineConfig(), device="cpu")
    # mesh= is ported (ROADMAP item 14): a non-mesh object is a TypeError
    with pytest.raises(TypeError, match="DeviceMesh"):
        tcore.run_pipeline_device(S, PipelineConfig(), mesh=object(),
                                  device="cpu")


def test_two_threads_cluster_at_one_n_get_reference_labels():
    from repro.core.pipeline import cluster as jcluster
    Xs = [make_dataset(36, 30, 3, noise=0.4, seed=s)[0] for s in (1, 2)]
    want = [jcluster(X, k=3, variant="opt").labels for X in Xs]
    got = [None] * 4
    errors = []

    def work(i):
        try:
            got[i] = tcore.cluster(Xs[i % 2], k=3, device="cpu").labels
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for i in range(4):
        np.testing.assert_array_equal(got[i], want[i % 2])
