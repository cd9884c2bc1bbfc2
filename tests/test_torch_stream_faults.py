"""The port's admission layer (``repro_torch.stream.admission``) under
injected faults, on the CPU, with the ``tests/faults.py`` harness: an
injected clock (no sleeps), scripted compute failures patched over
``repro_torch.stream.scheduler.pipeline.cluster_batch`` (the primary
lane) and ``repro_torch.stream.admission.pipeline.cluster`` (the
degraded lane), and seeded tenant traffic.

  * the token bucket and the circuit breaker's transitions;
  * a scripted failure run opens the breaker, the degraded lane answers
    with approx labels, ``healthz()`` reports it, and after the cooldown
    one probe closes it again;
  * quotas shed, identical in-flight requests coalesce, a dead degraded
    lane falls back to the last good result;
  * the same seeded traffic and failures give the reference service's
    outcomes, modes and labels.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.stream import ClusterService as JService  # noqa: E402
from repro.stream import AdmissionConfig as JAdmission  # noqa: E402
from repro.stream import scheduler as jsched  # noqa: E402
from repro_torch.stream import (AdmissionConfig,  # noqa: E402
                                CircuitBreaker, ClusterService, TokenBucket)
from repro_torch.stream import admission as adm_mod  # noqa: E402
from repro_torch.stream import scheduler as sched  # noqa: E402

from faults import (FakeClock, FlakyCluster, FlakyClusterBatch,  # noqa: E402
                    InjectedFault, TenantTraffic, similarity_pool)

pytestmark = pytest.mark.faults

N = 12          # one universe size for the file: the programs are reused
POOL = similarity_pool(N, 6, seed=7)


def make_svc(clk, **admission_kw):
    return ClusterService(n=N, window=48, k=3, max_batch=2,
                          admission=AdmissionConfig(**admission_kw),
                          clock=clk, device="cpu")


def test_token_bucket_burst_and_refill():
    clk = FakeClock()
    b = TokenBucket(rate=1.0, burst=2.0, clock=clk)
    assert b.try_take() and b.try_take() and not b.try_take()
    clk.advance(1.0)
    assert b.try_take() and not b.try_take()
    clk.advance(100.0)
    assert b.try_take() and b.try_take() and not b.try_take()


def test_breaker_transitions():
    clk = FakeClock()
    br = CircuitBreaker(failures=2, cooldown=5.0, probes=1, clock=clk)
    br.record_failure()
    br.record_success()                # streak broken
    br.record_failure()
    assert br.state == "closed"
    br.record_failure()
    assert br.state == "open" and not br.allow()
    clk.advance(5.0)
    assert br.state == "half_open" and br.allow() and not br.allow()
    br.record_failure()                # the probe failed: open again
    assert br.state == "open"
    clk.advance(5.0)
    assert br.allow()
    br.record_success()
    assert br.state == "closed"


def test_breaker_opens_degrades_and_recovers(monkeypatch):
    clk = FakeClock()
    svc = make_svc(clk, breaker_failures=2, breaker_cooldown=10.0,
                   degraded_sim_k=4)
    flaky = FlakyClusterBatch(sched.pipeline.cluster_batch, fail=2)
    monkeypatch.setattr(sched.pipeline, "cluster_batch", flaky)
    first = [svc.submit(POOL[i]) for i in range(2)]
    svc.drain()                        # failure 1: both tickets degrade
    assert all(t.degraded and t.mode == "approx" for t in first)
    assert svc.admission.breaker.state == "closed"
    t2 = svc.submit(POOL[2])
    svc.drain()                        # failure 2: the breaker opens
    assert svc.admission.breaker.state == "open"
    assert t2.done and t2.degraded and t2.outcome == "degraded"
    h = svc.healthz()
    assert h["status"] == "degraded" and h["breaker"] == "open"
    assert h["degraded_total"] == 3
    # while open, a submit is answered by the degraded lane at once
    t3 = svc.submit(POOL[3])
    assert t3.done and t3.degraded and t3.mode == "approx"
    assert t3.result.labels.shape == (N,) and len(set(t3.result.labels)) == 3
    assert flaky.calls == 2
    clk.advance(10.0)                  # cooldown: half-open, one probe
    t4 = svc.submit(POOL[4])
    svc.drain()
    assert t4.done and not t4.degraded and t4.outcome == "admitted"
    assert svc.admission.breaker.state == "closed"
    assert svc.healthz()["status"] == "ok" or not svc.healthz()["ready"]


def test_quota_coalesce_and_stale_fallback(monkeypatch):
    clk = FakeClock()
    svc = make_svc(clk, tenant_rate=1.0, tenant_burst=2.0,
                   breaker_failures=1, degraded_sim_k=4)
    a1, a1_twin = svc.submit(POOL[0], tenant="a"), svc.submit(POOL[0],
                                                              tenant="b")
    a2 = svc.submit(POOL[1], tenant="a")
    a3 = svc.submit(POOL[2], tenant="a")
    assert a1_twin.outcome == "coalesced" and a1_twin.primary is a1
    assert a3.outcome == "shed" and a3.mode == "quota" and a3.result is None
    svc.drain()
    assert a1.done and a1_twin.done and a2.done
    np.testing.assert_array_equal(a1.result.labels, a1_twin.result.labels)
    # both lanes dead: the last good result is served, labelled stale
    monkeypatch.setattr(sched.pipeline, "cluster_batch",
                        FlakyClusterBatch(None, forever=True))
    monkeypatch.setattr(adm_mod.pipeline, "cluster",
                        FlakyCluster(None, forever=True))
    clk.advance(10.0)
    t = svc.submit(POOL[3], tenant="b")
    svc.drain()
    assert t.degraded and t.mode == "stale" and t.result is not None
    with pytest.raises(InjectedFault):
        adm_mod.pipeline.cluster(S=POOL[3])


def _outcomes(svc, traffic, fail_at, monkeypatch, sched_mod):
    """Drive ``traffic`` through ``svc``, the primary lane failing on the
    pumps listed in ``fail_at``; returns each ticket's (outcome, mode,
    degraded, labels)."""
    real = sched_mod.pipeline.cluster_batch
    pumps = {"n": 0}

    def lane(*args, **kwargs):
        pumps["n"] += 1
        if pumps["n"] in fail_at:
            raise InjectedFault("scripted")
        return real(*args, **kwargs)
    monkeypatch.setattr(sched_mod.pipeline, "cluster_batch", lane)
    tickets = []
    for i, (tenant, S) in enumerate(traffic):
        tickets.append(svc.submit(S, tenant=tenant))
        if i % 3 == 2:
            svc.drain()
            svc.clock.advance(1.0)
    svc.drain()
    monkeypatch.setattr(sched_mod.pipeline, "cluster_batch", real)
    return [(t.outcome, t.mode, t.degraded,
             None if t.result is None else tuple(t.result.labels))
            for t in tickets]


def test_seeded_traffic_gives_the_reference_outcomes(monkeypatch):
    traffic = TenantTraffic(N, tenants=("a", "b"), weights=(3, 1), pool=4,
                            seed=3).take(12)
    policy = dict(tenant_rate=0.2, tenant_burst=2.0, breaker_failures=2,
                  breaker_cooldown=2.5, degraded_sim_k=4, max_queue=4)
    port = ClusterService(n=N, window=48, k=3, max_batch=2,
                          admission=AdmissionConfig(**policy),
                          clock=FakeClock(), device="cpu")
    ref = JService(n=N, window=48, k=3, max_batch=2,
                   admission=JAdmission(**policy), clock=FakeClock())
    got = _outcomes(port, traffic, {2, 3}, monkeypatch, sched)
    want = _outcomes(ref, traffic, {2, 3}, monkeypatch, jsched)
    assert [g[:3] for g in got] == [w[:3] for w in want]
    assert got == want
    assert {g[0] for g in got} >= {"admitted", "shed", "degraded"}
    assert port.admission.stats() == ref.admission.stats()
