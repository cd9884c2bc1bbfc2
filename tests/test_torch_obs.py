"""The port's observability layer (``repro_torch.obs``) and its program
cache (``repro_torch.core.jitcache``) against the reference's, on the CPU.

  * spans: nesting, per-thread stacks, collection only while tracing,
    refcounted tracing sessions, the reference's span record keys;
  * fencing: ``Span.fence`` waits (through ``trace.device_wait``, counted
    here) only when fenced and tracing is on; the fused ``cluster()``
    makes no wait, traced or not, and the staged one waits per stage;
  * the build counters and the watchdog: a replayed ``cluster()`` builds
    no loop program, a change of n or K builds at least one, and a
    replayed (config, shape) that builds one raises the alarm that
    ``ClusterService.healthz()`` reports;
  * the program cache: one loop program per device (a miss evicts the
    others, the (n, n) buffer with them), ``clear_compiled()`` empties
    it;
  * the registry and export: the reference's Prometheus text for the
    same registry, the ``jitcache`` collector's samples, JSON lines and
    the profiler's trace file;
  * wiring: the pipeline's histograms and spans, the batcher's dedupe
    counter, ``stats()``/``healthz()`` with the reference's keys.
"""

import gc
import json
import threading
import time
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import jitcache as jjitcache  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.obs.metrics import Registry as JRegistry  # noqa: E402
from repro.stream import service as jservice  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import jitcache  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import tmfg as ttmfg  # noqa: E402
from repro_torch.core.config import PipelineConfig  # noqa: E402
from repro_torch.obs import export as obs_export  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.obs.metrics import Registry  # noqa: E402
from repro_torch.stream import ClusterService  # noqa: E402
from repro_torch.stream.cache import ResultCache  # noqa: E402
from repro_torch.stream.scheduler import MicroBatcher  # noqa: E402

from conftest import clustered_similarity  # noqa: E402


@pytest.fixture
def waits(monkeypatch):
    """Count every call of the one function that waits on the device."""
    calls = []
    real = obs_trace.device_wait

    def counted(x):
        calls.append(x)
        real(x)
    monkeypatch.setattr(obs_trace, "device_wait", counted)
    return calls


def _S(n, seed=0):
    return clustered_similarity(n, k=3, seed=seed)[0].astype(np.float32)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def test_span_measures_nests_and_keeps_reference_keys():
    obs_trace.clear()
    with obs_trace.tracing():
        with obs_trace.span("outer") as outer:
            with obs_trace.span("inner", step=1) as inner:
                time.sleep(0.01)
    assert outer.duration >= inner.duration >= 0.01
    assert inner.parent == "outer" and inner.depth == 1
    assert [s.name for s in obs_trace.spans()] == ["inner", "outer"]
    want = jtrace.Span(name="x", attrs={"a": 1}).to_dict()
    assert set(inner.to_dict()) == set(want)


def test_spans_collected_only_while_enabled():
    obs_trace.clear()
    with obs_trace.span("off"):
        pass
    assert obs_trace.record_span("off2", 1.0) is None
    obs_trace.enable()
    try:
        with obs_trace.span("on"):
            obs_trace.record_span("child", 0.5, fenced=True)
        obs_trace.record_event("ev", x=1)
    finally:
        obs_trace.disable()
    spans = obs_trace.spans()
    assert [s.name for s in spans] == ["child", "on"]
    assert spans[0].parent == "on" and spans[0].duration == 0.5
    assert obs_trace.events("ev")[0]["x"] == 1
    obs_trace.clear()
    assert obs_trace.spans() == [] and obs_trace.events() == []


def test_per_thread_stacks_and_refcounted_sessions():
    obs_trace.clear()
    parents = {}
    inside = threading.Barrier(2)

    def work(name):
        with obs_trace.tracing():
            with obs_trace.span(name):
                inside.wait()
                with obs_trace.span(name + ".child") as sp:
                    pass
                parents[name] = sp.parent
            if name == "a":
                time.sleep(0.01)       # b's session ends first

    ts = [threading.Thread(target=work, args=(n,)) for n in "ab"]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert parents == {"a": "a", "b": "b"}
    assert len(obs_trace.spans()) == 4
    assert not obs_trace.enabled()


def test_fence_waits_only_when_fenced_and_tracing(waits):
    x = torch.ones(3)
    with obs_trace.span("f", fence=True) as sp:
        assert sp.fence(x) is x
    assert waits == []                 # tracing off: no wait
    with obs_trace.tracing():
        with obs_trace.span("u", fence=False) as sp:
            sp.fence(x)
        assert waits == []             # unfenced: never waits
        with obs_trace.span("f", fence=True) as sp:
            sp.fence(x)
    assert len(waits) == 1


@pytest.mark.parametrize("cfg", [PipelineConfig.opt(), PipelineConfig.mst()],
                         ids=["opt", "mst"])
def test_fused_cluster_makes_no_wait(waits, cfg):
    S = _S(30, seed=1)
    tpipe.cluster(S=S, k=3, config=cfg, device="cpu")
    assert waits == []
    obs_trace.clear()
    with obs_trace.tracing():
        tpipe.cluster(S=S, k=3, config=cfg, device="cpu")
    assert waits == []                 # the stage spans come from events
    names = [s.name for s in obs_trace.spans()]
    assert names[-1] == "pipeline.fused"
    assert {"pipeline.similarity", "pipeline.tmfg",
            "pipeline.dbht+apsp"} <= set(names)
    assert all(s.parent == "pipeline.fused" for s in obs_trace.spans()
               if s.name != "pipeline.fused")
    obs_trace.clear()


def test_staged_cluster_waits_per_stage_and_observes(waits):
    S = _S(30, seed=2)
    h = obs_metrics.histogram("pipeline_stage_seconds",
                              "staged-path per-stage latency (fenced)",
                              stage="tmfg")
    c0 = h.count
    obs_trace.clear()
    with obs_trace.tracing():
        res = tpipe.cluster(S=S, k=3, fused=False, device="cpu",
                            collect_timings=True)
    assert len(waits) >= 5             # similarity, tmfg, apsp, dbht, hac
    assert h.count == c0 + 1
    sp = {s.name: s for s in obs_trace.spans()}
    assert sp["pipeline.tmfg"].fenced
    assert sp["pipeline.tmfg"].duration == pytest.approx(
        res.timings["tmfg"])
    obs_trace.clear()


# ---------------------------------------------------------------------------
# program builds and the recompile watchdog
# ---------------------------------------------------------------------------

def test_replayed_cluster_builds_no_program_changes_do():
    S = _S(28, seed=3)
    tpipe.cluster(S=S, k=3, device="cpu")
    with obs_trace.watch_recompiles() as w:
        tpipe.cluster(S=S, k=3, device="cpu")
        tpipe.cluster(S=_S(28, seed=4), k=3, device="cpu")
    assert w.count == 0 and w.recompile_events == 0
    with obs_trace.watch_recompiles() as w_n:
        tpipe.cluster(S=_S(29, seed=3), k=3, device="cpu")
    assert w_n.count >= 1
    with obs_trace.watch_recompiles() as w_k:
        tpipe.cluster(S=S, k=3, config=PipelineConfig().replace(topk=8),
                      device="cpu")
    assert w_k.count >= 1 and w_k.compile_s >= 0.0
    # a span sees the programs built inside it
    with obs_trace.span("cold") as sp:
        tpipe.cluster(S=_S(27, seed=3), k=3, device="cpu")
    assert sp.compiles >= 1 and sp.run_s <= sp.duration


def test_watchdog_fires_on_replay_that_builds(monkeypatch):
    S = _S(26, seed=5)
    tpipe.cluster(S=S, k=3, device="cpu")
    before = obs_trace.compile_stats()["recompile_events"]
    # a new T is a new loop program under the same (config, shape)
    monkeypatch.setattr(ttmfg, "STEPS_PER_SYNC", 5)
    tpipe.cluster(S=S, k=3, device="cpu")
    assert obs_trace.compile_stats()["recompile_events"] == before + 1
    ev = obs_trace.recompile_events()[-1]
    assert ev["name"] == "recompile" and "(26, 26)" in ev["shape"]
    svc = ClusterService(n=8, window=4, device="cpu")
    assert svc.healthz()["recompile_events"] == before + 1


def test_program_cache_holds_and_clear_compiled_releases():
    S = _S(25, seed=6)
    tpipe.cluster(S=S, k=3, device="cpu")
    progs = [jitcache._cache[k] for k in jitcache.keys()
             if k[0] == "tmfg.lazy" and k[2] == 25]
    assert progs and progs[0].runs >= 1
    assert jitcache.nbytes() >= 25 * 25 * 4
    assert all(k[0] == "tmfg.lazy" for k in jitcache.keys())
    assert any(k[4] == (25, 25) for k in tpipe._seen_fused)
    tpipe.clear_compiled()
    assert jitcache.size() == 0 and jitcache.nbytes() == 0
    assert not tpipe._seen_fused
    with obs_trace.watch_recompiles() as w:
        tpipe.cluster(S=S, k=3, device="cpu")
    assert w.count >= 1                # rebuilt after the clear


def test_program_miss_evicts_the_other_programs():
    """A loop program that misses evicts the others on its device first:
    a dense call, then one at another n, then an approx call at that n
    leave one program, and the (n, n) S buffer goes with the dense one."""
    tpipe.clear_compiled()
    ev0 = jitcache.stats()["evictions"]

    def programs():
        return [k for k in jitcache.keys() if k[0] == "tmfg.lazy"]
    tpipe.cluster(S=_S(30, seed=7), k=3, device="cpu")
    tpipe.cluster(S=_S(31, seed=7), k=3, device="cpu")
    assert [k[1:3] for k in programs()] == [("dense", 31)]
    S_buf = weakref.ref(jitcache._cache[programs()[0]].d.S)
    assert S_buf().shape == (31, 31)
    X = np.random.default_rng(7).standard_normal((31, 24)).astype(np.float32)
    tpipe.cluster(X, k=3, config=PipelineConfig.approx(sim_k=8),
                  device="cpu")
    assert [k[1:3] for k in programs()] == [("table", 31)]
    gc.collect()
    assert S_buf() is None
    assert jitcache.stats()["evictions"] == ev0 + 2
    # a steady caller at one shape keeps its program
    with obs_trace.watch_recompiles() as w:
        tpipe.cluster(X, k=3, config=PipelineConfig.approx(sim_k=8),
                      device="cpu")
    assert w.count == 0 and jitcache.stats()["evictions"] == ev0 + 2


# ---------------------------------------------------------------------------
# registry + export
# ---------------------------------------------------------------------------

def _fill(reg):
    reg.counter("req_total", "served requests", path="/a").inc(3)
    reg.counter("req_total", "served requests", path="/b").inc(1.5)
    reg.gauge("depth", "queue depth").set(2)
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    for v in (0.5, 0.5, 2.0):
        h.observe(v)
    reg.register_collector("ext", lambda: {"ext_val": 7.0,
                                           "a_first": 0.25})
    reg.histogram("dflt_seconds").observe(0.003)


@pytest.mark.parametrize("fill", [True, False], ids=["filled", "empty"])
def test_render_is_the_reference_text(fill):
    reg, jreg = Registry(), JRegistry()
    if fill:
        _fill(reg)
        _fill(jreg)
    text = obs_export.render(reg)
    assert text == jexport.render(jreg)
    assert reg.snapshot() == jreg.snapshot()
    if fill:
        assert reg.family_total("req_total") == 4.5
        assert 'lat_seconds_bucket{le="+Inf"} 3' in text
    else:
        assert text == ""


def test_registry_reset_and_kind_clash():
    reg = Registry()
    c = reg.counter("x_total")
    assert reg.counter("x_total") is c
    c.inc(2)
    reg.register_collector("ext", lambda: {"y": 1.0})
    reg.reset()
    assert c.value == 0.0 and reg.snapshot()["y"] == 1.0
    with pytest.raises(ValueError):
        reg.gauge("x_total")
    with pytest.raises(ValueError):
        c.inc(-1)


def test_jitcache_collector_matches_reference():
    out = []
    for jc in (jitcache, jjitcache):
        jc.clear()
        jc.reset_stats()
        prev = jc.set_maxsize(2)
        jc.cached(("obs-test", 1), lambda: "a")
        jc.cached(("obs-test", 2), lambda: "b")
        jc.cached(("obs-test", 1), lambda: "a")      # hit
        jc.cached(("obs-test", 3), lambda: "c")      # evicts 2
        assert jc.contains(("obs-test", 1))
        assert not jc.contains(("obs-test", 2))
        ages = jc.last_hit_ages()
        assert all(a >= 0.0 for a in ages.values())
        snap = {k: v for k, v in jc._collect().items()
                if k != "jitcache_oldest_idle_seconds"}
        out.append((jc.stats(), jc.keys(), jc.size(), snap))
        jc.set_maxsize(prev)
        jc.reset_stats()
        jc.clear()
    assert out[0] == out[1]
    assert out[0][0] == {"hits": 1, "misses": 3, "evictions": 1}
    assert "jitcache_hits_total" in obs_metrics.snapshot()


def test_dump_jsonl_and_profile(tmp_path):
    obs_trace.clear()
    with obs.profile(str(tmp_path / "prof")) as prof:
        tpipe.cluster(S=_S(20, seed=7), k=3, device="cpu")
    assert prof.trace_path.startswith(str(tmp_path / "prof"))
    with open(prof.trace_path) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    n = obs.dump_jsonl(str(tmp_path / "dump.jsonl"))
    rows = [json.loads(line) for line in open(tmp_path / "dump.jsonl")]
    assert len(rows) == n and rows[-1]["kind"] == "metrics"
    assert any(r.get("name") == "pipeline.fused" for r in rows)
    assert "programs" in rows[-1]["compile"]
    obs_trace.clear()


# ---------------------------------------------------------------------------
# wiring: batcher dedupe, service stats()/healthz()
# ---------------------------------------------------------------------------

def test_batcher_dedup_counter():
    S = _S(24, seed=3)
    before = obs_metrics.counter("batcher_dedup_hits_total").value
    mb = MicroBatcher(max_batch=4, cache=ResultCache(8), device="cpu")
    r1, r2 = mb.submit(S, k=3), mb.submit(S, k=3)
    mb.flush()
    assert r1.done and r2.done and mb.dedup_hits == 1
    assert np.array_equal(r1.result.labels, r2.result.labels)
    assert obs_metrics.counter("batcher_dedup_hits_total").value \
        == before + 1
    assert r1.apsp_method == "hub"                   # ConfigFields


def test_service_stats_and_healthz_keys_are_the_references():
    svc = ClusterService(n=16, window=8, k=3, recluster_every=4,
                         device="cpu")
    jsvc = jservice.ClusterService(n=16, window=8, k=3, recluster_every=4)
    h0 = svc.healthz()
    assert set(h0) == set(jsvc.healthz())
    assert h0["status"] == "warming" and not h0["ready"]
    rng = np.random.default_rng(0)
    for _ in range(8):
        svc.tick(rng.normal(size=16).astype(np.float32))
    svc.drain()
    h = svc.healthz()
    assert h["status"] == "ok" and h["ready"] and h["window_filled"] == 8
    assert h["jitcache_size"] == jitcache.size() > 0
    snap = svc.stats()
    assert snap["service_ticks"] == 8.0
    assert snap["service_batches_run"] == 1.0
    assert "service_tick_seconds_count" in snap
    assert "pipeline_total_seconds_count{path=\"fused\"}" in snap
    text = obs.render()
    assert "# TYPE service_tick_seconds histogram" in text
    assert "jitcache_size" in text
