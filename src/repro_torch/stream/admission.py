"""Admission control for the serving tier (DESIGN.md §16).

The port of ``repro.stream.admission``, with its classes and policy:
queue-based load leveling in front of the
:class:`~repro_torch.stream.scheduler.MicroBatcher`:

* a **bounded admission queue** (§16.1) — ``submit`` never blocks on
  compute; it admits the request into the queue (work happens at the
  next :meth:`AdmissionController.pump`), answers it from the content
  cache, coalesces it onto an identical in-flight request (idempotent
  submit keyed on the §10.3 content hash), or resolves it through the
  degraded lane.  Execution stays single-threaded and deterministic, so
  every transition can be pinned with an injected clock and zero sleeps
  (``tests/faults.py``).
* **per-tenant token-bucket quotas** (§16.2) — one :class:`TokenBucket`
  per tenant; a tenant past its refill rate is shed with
  ``reason="quota"``.
* a **circuit breaker with a degraded mode** (§16.3) — consecutive flush
  failures open the :class:`CircuitBreaker`; while it is open (and past
  the queue's watermark) requests are served by the degraded lane — a
  stale cache re-probe, the port's ``cluster`` with
  ``cfg.replace(similarity="topk", sim_k=...)``, or the last good result
  — instead of collapsing the queue.  After ``cooldown`` seconds the
  breaker half-opens and one probe flush decides open vs closed.

Everything is exported through the §15.3 registry
(``admission_queue_depth``, ``admission_shed_total{reason=}``,
``admission_degraded_total{mode=}``, ``breaker_state``) and surfaced by
``ClusterService.healthz()``.  ``device`` (default: CUDA) is where the
degraded lane clusters.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from repro_torch.core import pipeline
from repro_torch.core.config import PipelineConfig
from repro_torch.obs import metrics as obs_metrics
from .cache import content_key

Clock = Callable[[], float]


# ---------------------------------------------------------------------------
# per-tenant quotas (§16.2)
# ---------------------------------------------------------------------------

class TokenBucket:
    """Token-bucket rate limiter (DESIGN.md §16.2): ``rate``
    tokens/second refill up to a ``burst`` cap; :meth:`try_take`
    consumes one or rejects.  The clock is injected so quota exhaustion
    and refill are testable without sleeping (tests/faults.py)."""

    def __init__(self, rate: float, burst: float, clock: Clock):
        assert burst > 0, f"burst must be > 0, got {burst}"
        assert rate > 0, f"rate must be > 0, got {rate}"
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self.tokens = float(burst)
        self._last = clock()

    def try_take(self, n: float = 1.0) -> bool:
        if math.isinf(self.rate):
            return True
        now = self._clock()
        self.tokens = min(self.burst,
                          self.tokens + (now - self._last) * self.rate)
        self._last = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


# ---------------------------------------------------------------------------
# the circuit breaker (§16.3)
# ---------------------------------------------------------------------------

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_CODE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


class CircuitBreaker:
    """Consecutive-failure circuit breaker over the compute lane.

    ``failures`` consecutive :meth:`record_failure` calls open the
    breaker; after ``cooldown`` seconds it half-opens and admits up to
    ``probes`` probe executions — one success closes it, one failure
    re-opens it (and restarts the cooldown).  State transitions land on
    the ``breaker_state`` gauge (0 closed / 1 half-open / 2 open) and a
    ``breaker_transitions_total{to=}`` counter (DESIGN.md §16.3).
    """

    def __init__(self, failures: int = 3, cooldown: float = 5.0,
                 probes: int = 1, clock: Clock = time.monotonic):
        assert failures >= 1 and probes >= 1 and cooldown >= 0.0
        self.failure_threshold = failures
        self.cooldown = float(cooldown)
        self.probes = probes
        self._clock = clock
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probes_inflight = 0
        self._m_state = obs_metrics.gauge(
            "breaker_state", "circuit breaker: 0 closed, 1 half-open, 2 open")
        self._m_state.set(_STATE_CODE[CLOSED])

    def _set(self, state: str) -> None:
        if state != self._state:
            obs_metrics.counter("breaker_transitions_total",
                                "breaker state transitions",
                                to=state).inc()
        self._state = state
        self._m_state.set(_STATE_CODE[state])

    @property
    def state(self) -> str:
        """Current state, cooldown-aware: reading it performs the
        open → half-open transition once the cooldown has elapsed."""
        if (self._state == OPEN
                and self._clock() - self._opened_at >= self.cooldown):
            self._probes_inflight = 0
            self._set(HALF_OPEN)
        return self._state

    def allow(self) -> bool:
        """May the *primary* compute lane run right now?  In half-open,
        each ``allow()`` consumes one of the ``probes`` slots."""
        st = self.state
        if st == CLOSED:
            return True
        if st == HALF_OPEN and self._probes_inflight < self.probes:
            self._probes_inflight += 1
            return True
        return False

    def record_success(self) -> None:
        if self.state == HALF_OPEN:
            self._set(CLOSED)
        self._consecutive = 0

    def record_failure(self) -> None:
        self._consecutive += 1
        st = self.state
        if st == HALF_OPEN or (st == CLOSED
                               and self._consecutive >= self.failure_threshold):
            self._opened_at = self._clock()
            self._set(OPEN)


# ---------------------------------------------------------------------------
# policy + tickets (§16.1)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AdmissionConfig:
    """Frozen policy bundle for the admission layer (DESIGN.md §16.1).

    Fields:
      max_queue:         bounded admission-queue depth; a submit that
                         would exceed it is degraded/shed, never queued.
      degrade_watermark: queue fraction at which new admits start
                         routing to the degraded lane *before* the hard
                         bound (load shedding ahead of collapse).
      tenant_rate:       per-tenant token refill, requests/second
                         (``inf`` disables quotas).
      tenant_burst:      per-tenant bucket capacity (burst allowance).
      breaker_failures:  consecutive flush failures that open the
                         breaker.
      breaker_cooldown:  seconds the breaker stays open before
                         half-opening.
      breaker_probes:    probe executions admitted while half-open.
      degraded_sim_k:    candidate-table width for the degraded
                         ``.approx(sim_k=...)`` fallback clustering
                         (0 disables the approx lane).
      serve_stale:       allow the last good result as the final
                         degraded fallback before shedding.
    """

    max_queue: int = 64
    degrade_watermark: float = 0.75
    tenant_rate: float = math.inf
    tenant_burst: float = 32.0
    breaker_failures: int = 3
    breaker_cooldown: float = 5.0
    breaker_probes: int = 1
    degraded_sim_k: int = 16
    serve_stale: bool = True

    def __post_init__(self):
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if not 0.0 < self.degrade_watermark <= 1.0:
            raise ValueError(f"degrade_watermark must be in (0, 1], got "
                             f"{self.degrade_watermark}")
        if self.degraded_sim_k < 0:
            raise ValueError(f"degraded_sim_k must be >= 0, got "
                             f"{self.degraded_sim_k}")


@dataclass(eq=False)        # identity semantics (S is an ndarray)
class Ticket:
    """One admission decision; resolved in place like a ClusterRequest.

    ``outcome`` is the admission verdict — ``"admitted"`` (queued for
    the next pump), ``"cached"`` (content-cache hit at submit),
    ``"coalesced"`` (idempotent duplicate of an in-flight admit),
    ``"degraded"`` (served by the §16.3 degraded lane; ``mode`` says
    which: ``"cached"``/``"approx"``/``"stale"``), or ``"shed"``
    (rejected; ``mode`` carries the reason: ``"quota"``,
    ``"queue_full"``, ``"overload"``, ``"breaker_open"``,
    ``"compute_error"``).  ``degraded`` results are always labeled —
    a caller can tell an exact answer from a fallback one.
    """

    outcome: str
    tenant: str
    ck: str
    S: Optional[np.ndarray] = None
    k: Optional[int] = None
    mode: str = ""
    result: Optional[pipeline.ClusterResult] = None
    done: bool = False
    degraded: bool = False
    cached: bool = False
    t_submit: float = 0.0
    t_done: Optional[float] = None
    request: object = None                  # the ClusterRequest, post-pump
    primary: Optional["Ticket"] = None      # coalesced → its admitted twin
    twins: List["Ticket"] = field(default_factory=list)

    @property
    def shed(self) -> bool:
        return self.outcome == "shed"

    @property
    def waited(self) -> Optional[float]:
        """Submit-to-resolution latency (None while unresolved)."""
        return None if self.t_done is None else self.t_done - self.t_submit


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

class AdmissionController:
    """Bounded async admission queue feeding the MicroBatcher (§16.1).

    ``submit`` classifies a request in O(hash) time and never runs the
    pipeline; ``pump`` moves at most one bucket (``batcher.max_batch``
    requests) from the admission queue into the batcher and flushes it
    under breaker accounting.  All time comes from the injected
    ``clock``, so every decision in this class is deterministic under
    the fault harness (tests/faults.py).
    """

    def __init__(self, *, batcher, cfg: PipelineConfig,
                 policy: Optional[AdmissionConfig] = None, cache=None,
                 clock: Clock = time.monotonic, device=None):
        self.batcher = batcher
        self.cfg = cfg
        self.device = device
        self.cache = cache
        self.policy = policy if policy is not None else AdmissionConfig()
        self.clock = clock
        self.queue: Deque[Ticket] = deque()
        self._inflight: Dict[str, Ticket] = {}
        self.buckets: Dict[str, TokenBucket] = {}
        self.breaker = CircuitBreaker(
            failures=self.policy.breaker_failures,
            cooldown=self.policy.breaker_cooldown,
            probes=self.policy.breaker_probes, clock=clock)
        self.last_good: Optional[pipeline.ClusterResult] = None
        # local source-of-truth counters (healthz reads these; the
        # registry instruments below aggregate process-wide, §15.3)
        self.admitted_total = 0
        self.shed_total = 0
        self.degraded_total = 0
        self.coalesced_total = 0
        self.tenant_stats: Dict[str, Dict[str, int]] = {}
        self._m_depth = obs_metrics.gauge(
            "admission_queue_depth", "tickets waiting for a pump")
        self._m_admit = obs_metrics.counter(
            "admission_admitted_total", "requests admitted into the queue")
        self._m_idem = obs_metrics.counter(
            "admission_idempotent_hits_total",
            "submits coalesced onto an identical in-flight request")
        self._m_wait = obs_metrics.histogram(
            "admission_wait_seconds", "submit-to-resolution latency")

    # -- config helpers -----------------------------------------------------
    def degraded_config(self, n: int) -> Optional[PipelineConfig]:
        """The cheap config the degraded lane clusters with (§16.3): the
        service's own config shifted to ``similarity="topk"`` at
        ``sim_k = min(degraded_sim_k, n-1)``.  Exposed so a caller can pre-warm its programs.
        Returns None when the approx lane is disabled or n is too
        small to sparsify."""
        kk = min(self.policy.degraded_sim_k, n - 1)
        if kk < 1:
            return None
        return self.cfg.replace(similarity="topk", sim_k=kk)

    def _tenant(self, tenant: str) -> Dict[str, int]:
        return self.tenant_stats.setdefault(
            tenant, {"admitted": 0, "shed": 0, "degraded": 0})

    # -- submit (§16.1/§16.2) ----------------------------------------------
    def submit(self, S, *, k: Optional[int] = None,
               tenant: str = "default") -> Ticket:
        """Classify one request; never blocks on pipeline work."""
        S = np.asarray(S, np.float32)
        ck = content_key(S, (k,) + self.cfg.content_key())
        now = self.clock()

        # cache-aside: identical content already answered
        if self.cache is not None:
            hit = self.cache.get(ck)
            if hit is not None:
                self.last_good = hit
                return Ticket(outcome="cached", tenant=tenant, ck=ck, S=S,
                              k=k, result=hit, done=True, cached=True,
                              t_submit=now, t_done=now)

        # idempotent submit (§16.1): identical bytes+config in flight —
        # coalesce onto the admitted twin; costs no queue slot, no quota
        prim = self._inflight.get(ck)
        if prim is not None:
            t = Ticket(outcome="coalesced", tenant=tenant, ck=ck, S=S, k=k,
                       primary=prim, t_submit=now)
            prim.twins.append(t)
            self.coalesced_total += 1
            self._m_idem.inc()
            return t

        # per-tenant quota (§16.2): a tenant past its refill is shed
        # outright — quota violations never earn degraded service
        bucket = self.buckets.get(tenant)
        if bucket is None:
            bucket = self.buckets[tenant] = TokenBucket(
                self.policy.tenant_rate, self.policy.tenant_burst,
                self.clock)
        if not bucket.try_take():
            return self._shed(tenant, ck, S, k, reason="quota", now=now)

        # breaker open: the primary lane is known-bad — degraded lane
        # (half-open admits normally; the pump probes)
        if self.breaker.state == OPEN:
            return self._degrade(tenant, ck, S, k, reason="breaker_open",
                                 now=now)

        # bounded queue (§16.1): hard bound sheds, watermark degrades
        depth = len(self.queue)
        if depth >= self.policy.max_queue:
            return self._degrade(tenant, ck, S, k, reason="queue_full",
                                 now=now)
        if depth >= self.policy.degrade_watermark * self.policy.max_queue:
            return self._degrade(tenant, ck, S, k, reason="overload",
                                 now=now)

        t = Ticket(outcome="admitted", tenant=tenant, ck=ck, S=S, k=k,
                   t_submit=now)
        self.queue.append(t)
        self._inflight[ck] = t
        self.admitted_total += 1
        self._tenant(tenant)["admitted"] += 1
        self._m_admit.inc()
        self._m_depth.set(len(self.queue))
        return t

    # -- degraded lane + shedding (§16.3) -----------------------------------
    def _shed(self, tenant: str, ck: str, S, k, *, reason: str,
              now: float) -> Ticket:
        self.shed_total += 1
        self._tenant(tenant)["shed"] += 1
        obs_metrics.counter("admission_shed_total",
                            "requests shed by the admission layer",
                            reason=reason).inc()
        return Ticket(outcome="shed", tenant=tenant, ck=ck, S=S, k=k,
                      mode=reason, done=True, t_submit=now, t_done=now)

    def _degrade(self, tenant: str, ck: str, S, k, *, reason: str,
                 now: float) -> Ticket:
        """Serve through the degraded lane instead of collapsing: a
        stale cache re-probe, the cheap approx clustering, the last
        good result — shedding only when all three are unavailable.
        Degraded results are always labeled (``degraded=True`` plus the
        ``mode`` that produced them)."""
        result, mode = None, ""
        if self.cache is not None and result is None:
            hit = self.cache.get_stale(ck)
            if hit is not None:
                result, mode = hit, "cached"
        if result is None:
            dcfg = self.degraded_config(np.asarray(S).shape[0])
            if dcfg is not None:
                try:
                    result, mode = pipeline.cluster(
                        S=S, k=k, config=dcfg, device=self.device), "approx"
                except Exception:   # noqa: BLE001 — fall through to stale
                    result = None
        if result is None and self.policy.serve_stale \
                and self.last_good is not None:
            result, mode = self.last_good, "stale"
        if result is None:
            return self._shed(tenant, ck, S, k, reason=reason, now=now)
        self.degraded_total += 1
        self._tenant(tenant)["degraded"] += 1
        obs_metrics.counter("admission_degraded_total",
                            "requests served by the degraded lane",
                            mode=mode).inc()
        return Ticket(outcome="degraded", tenant=tenant, ck=ck, S=S, k=k,
                      mode=mode, result=result, done=True, degraded=True,
                      cached=mode == "cached", t_submit=now, t_done=now)

    # -- pump: queue → batcher → flush (§16.1/§16.3) ------------------------
    def _resolve(self, t: Ticket, result, *, degraded: bool = False,
                 mode: str = "") -> None:
        t.result, t.done = result, True
        t.degraded, t.t_done = degraded, self.clock()
        if mode:
            t.mode = mode
        if t.waited is not None:
            self._m_wait.observe(t.waited)
        for tw in t.twins:
            tw.result, tw.done = result, True
            tw.degraded, tw.mode = degraded, t.mode
            tw.t_done = t.t_done

    def _finish_degraded(self, t: Ticket, reason: str,
                         out: List[Ticket]) -> None:
        """Resolve an already-admitted ticket through the degraded lane
        (primary lane failed or is open at pump time)."""
        self._inflight.pop(t.ck, None)
        d = self._degrade(t.tenant, t.ck, t.S, t.k, reason=reason,
                          now=t.t_submit)
        t.outcome, t.cached = d.outcome, d.cached
        self._resolve(t, d.result, degraded=d.degraded, mode=d.mode)
        out.append(t)

    def pump(self) -> List[Ticket]:
        """Feed at most one bucket of queued tickets into the batcher
        and flush it, breaker-accounted; returns every ticket resolved
        by this call (including coalesced twins)."""
        resolved: List[Ticket] = []
        if not self.queue:
            return resolved

        if not self.breaker.allow():
            # primary lane down: the backlog resolves through the
            # degraded lane instead of rotting in the queue (§16.3)
            while self.queue:
                self._finish_degraded(self.queue.popleft(), "breaker_open",
                                      resolved)
            self._m_depth.set(0)
            return resolved + [tw for t in resolved for tw in t.twins]

        batch = [self.queue.popleft()
                 for _ in range(min(len(self.queue), self.batcher.max_batch))]
        self._m_depth.set(len(self.queue))
        for t in batch:
            req = self.batcher.submit(t.S, k=t.k, config=self.cfg)
            req.ck = t.ck               # digest already paid at admission
            t.request = req
        try:
            self.batcher.flush()
            self.breaker.record_success()
        except Exception:   # noqa: BLE001 — the breaker owns the verdict
            self.breaker.record_failure()
        for t in batch:
            if t.request.done:
                self._inflight.pop(t.ck, None)
                t.cached = t.request.cached
                self._resolve(t, t.request.result)
                if not t.degraded:
                    self.last_good = t.request.result
                resolved.append(t)
            else:
                # flush failed before this request ran — degraded lane,
                # never a silent requeue (the §10.2 flush contract)
                self._finish_degraded(t, "compute_error", resolved)
        return resolved + [tw for t in resolved for tw in t.twins]

    # -- introspection ------------------------------------------------------
    def __len__(self) -> int:
        return len(self.queue)

    def stats(self) -> Dict[str, float]:
        """Local admission counters (the per-instance view; the §15.3
        registry aggregates the same events process-wide)."""
        return {
            "admission_queue_depth": float(len(self.queue)),
            "admitted_total": float(self.admitted_total),
            "shed_total": float(self.shed_total),
            "degraded_total": float(self.degraded_total),
            "coalesced_total": float(self.coalesced_total),
            "breaker_state": _STATE_CODE[self.breaker.state],
        }
