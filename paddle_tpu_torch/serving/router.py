"""Replicated serving: health-checked router, failover, QoS admission
(a copy of `paddle_tpu/serving/router.py`).

One `InferenceEngine` is one failure domain: when it dies mid-decode,
every accepted request it held dies with it, and nothing tells clients
to back off when it saturates. Production TPU serving fleets
(MegaScale-style, Jiang et al. NSDI'24) treat replica failure and
overload as the STEADY STATE; this module composes the pieces the
repo already has — the continuous-batching engine, the
transient-error classifier, graceful drain + degraded-state
health — into that posture:

- `ReplicaSet` owns N engine replicas of the same weights
  (independent slot pools, independent captured graphs), each tagged
  with an observability scope ('replica:N') so degraded states are
  attributable per replica. Unlike the JAX package's replicas, which
  share one parameter snapshot, each port replica past the first holds
  its own copy of the parameters (see `ReplicaSet`).
- `Router` places each accepted request on the healthy replica with
  the fewest outstanding decode tokens (least-loaded, not round-robin:
  a replica stuck behind a long-budget batch stops receiving work).
  Replicas are EXCLUDED while any degraded state (draining / resizing /
  hang_suspected) is active for their scope — the same machinery
  /healthz reports, not a parallel health system.
- Failover: a replica failure mid-step evicts its accepted-but-
  unfinished requests and resubmits them to survivors — IF the failure
  classifies as transient (`resilience.retry.is_transient`, which walks
  the `__cause__` chain, so the `ReplicaFailure`-wrapped transient error
  still reads as transient) and the per-request failover budget is not
  exhausted. Otherwise the request FAILS with the typed
  `ReplicaFailure` — accepted requests complete or fail loudly, never
  silently vanish. Greedy (and seeded-sampling) requests re-decode
  deterministically, so a failed-over request's tokens are bit-identical
  to an undisturbed run. In the port a CUDA error is never transient
  (`resilience.retry.is_transient`): a replica whose graph replay or
  kernel faults fails its requests with the typed `ReplicaFailure`.
- A per-replica `CircuitBreaker` (closed -> open on consecutive
  failures -> half-open single probe -> closed) keeps the router from
  hammering a sick replica with resubmissions.
- Admission control (`tenancy.py`): per-tenant token-bucket rate +
  concurrency caps + priority classes, and explicit load shedding —
  past the queue-depth / estimated-TTFT budget, work below the
  protected priority is rejected FAST with a typed `AdmissionRejected`
  carrying a `retry_after_s` hint, before any prefill happens.

Everything reports: `paddle_router_*` metrics, `router_failover` /
`request_shed` / `breaker_*` events, a flight-recorder bundle on
failover storms, and a per-replica router section in
`debug.observability_summary()` / the HTTP `/summary`.

`Router.step` steps the replicas in turn on the calling thread, and a
port engine's round returns only after its token fetch: on one card the
replicas' rounds run one after another, so two replicas there measure
the router at twice the slots, not hardware scaling.
"""
from __future__ import annotations

import collections
import copy
import itertools
import time
from typing import Callable, List, Optional, Sequence

import torch

from .. import observability as _obs
from ..analysis.runtime import concurrency as _concurrency
from ..resilience.retry import is_transient
from .api import (FAILED, FINISHED, PRIORITY_LOW, QUEUED, RequestHandle,
                  SamplingParams)
from .engine import InferenceEngine
from .tenancy import (AdmissionRejected, TenantRegistry,
                      estimate_queue_rounds, parse_tenant_spec)

_router_ids = itertools.count()

# breaker states (gauge encoding: closed=0, half_open=1, open=2)
BREAKER_CLOSED = 'closed'
BREAKER_HALF_OPEN = 'half_open'
BREAKER_OPEN = 'open'
_BREAKER_GAUGE = {BREAKER_CLOSED: 0, BREAKER_HALF_OPEN: 1, BREAKER_OPEN: 2}


class ReplicaFailure(RuntimeError):
    """A replica failed with requests in flight. Raised `from` the
    underlying error, so the transient classifier (which walks
    `__cause__`) still sees the root cause; carried as the typed error
    on requests whose failover budget is exhausted (or whose root cause
    is fatal)."""

    def __init__(self, replica_id: int, msg: str):
        self.replica_id = replica_id
        super().__init__(msg)


class CircuitBreaker:
    """Per-replica circuit breaker: closed -> open after
    `failure_threshold` CONSECUTIVE failures -> half-open after
    `reset_after_s` -> one probe decides (success closes, failure
    reopens). `clock` is injectable for tests."""

    def __init__(self, name: str = '', failure_threshold: int = 3,
                 reset_after_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.name = str(name)
        self.failure_threshold = int(failure_threshold)
        self.reset_after_s = float(reset_after_s)
        self._clock = clock
        self._state = BREAKER_CLOSED
        self._consecutive = 0
        self._opened_at: Optional[float] = None
        self._probing = False

    def _transition(self, state: str, **attrs):
        if state == self._state:
            return
        self._state = state
        _obs.emit(f'breaker_{state}', replica=self.name, **attrs)
        if _obs.enabled():
            reg = _obs.get_registry()
            reg.counter('paddle_router_breaker_transitions_total',
                        'circuit-breaker state transitions',
                        ('replica', 'state')).labels(
                            replica=self.name, state=state).inc()
            reg.gauge('paddle_router_breaker_state',
                      'breaker state per replica (0 closed, 1 half-open,'
                      ' 2 open)', ('replica',)).labels(
                          replica=self.name).set(_BREAKER_GAUGE[state])

    @property
    def state(self) -> str:
        """Current state; an elapsed open-cooldown surfaces as
        half_open (the transition happens on inspection)."""
        if (self._state == BREAKER_OPEN and self._opened_at is not None
                and self._clock() - self._opened_at >= self.reset_after_s):
            self._probing = False
            self._transition(BREAKER_HALF_OPEN)
        return self._state

    def admits(self) -> bool:
        """May the router place NEW work here? Open: no. Half-open:
        only the single probe (claim it with `begin_probe`)."""
        s = self.state
        if s == BREAKER_CLOSED:
            return True
        if s == BREAKER_HALF_OPEN:
            return not self._probing
        return False

    def begin_probe(self):
        if self.state == BREAKER_HALF_OPEN:
            self._probing = True

    def record_success(self):
        self._consecutive = 0
        self._probing = False
        if self._state != BREAKER_CLOSED:
            self._transition(BREAKER_CLOSED)

    def record_failure(self):
        self._consecutive += 1
        self._probing = False
        if (self.state == BREAKER_HALF_OPEN
                or self._consecutive >= self.failure_threshold):
            self._opened_at = self._clock()
            self._transition(BREAKER_OPEN,
                             consecutive_failures=self._consecutive)


class Replica:
    """One engine + its breaker + its observability scope."""

    def __init__(self, rid: int, engine: InferenceEngine,
                 breaker: Optional[CircuitBreaker] = None):
        self.id = int(rid)
        self.engine = engine
        self.scope = f'replica:{self.id}'
        engine.obs_scope = self.scope
        self.breaker = breaker or CircuitBreaker(name=str(self.id))
        self.failures = 0

    def health_states(self) -> set:
        """Active degraded states for this replica: its own scope, plus
        process-global states (a process-wide 'resizing' grounds every
        replica), plus watchdog hang suspicion."""
        states = set(_obs.degraded_states(scope=self.scope))
        states |= set(_obs.degraded_states(scope=None))
        if _obs.hang_suspected():
            states.add('hang_suspected')
        return states

    def outstanding_tokens(self) -> int:
        """The placement score: decode tokens still owed to accepted
        requests (in-flight remaining budgets + queued full budgets)."""
        eng = self.engine
        out = 0
        for h in eng._slot_req.values():
            out += max(h.params.max_new_tokens - len(h.tokens), 0)
        for h in eng.scheduler.pending():
            out += h.params.max_new_tokens
        return out

    def __repr__(self):
        return (f'Replica({self.id}, breaker={self.breaker.state}, '
                f'states={sorted(self.health_states())}, '
                f'outstanding={self.outstanding_tokens()})')


def replica_model(model):
    """A copy of `model` with parameters and buffers of its own, on the
    same device (`copy.deepcopy`; an adapter bank's tags on its
    projections are copied with them).

    A port engine's `swap_weights` copies a published version into its
    model's parameters in place, which keeps every captured graph's
    addresses valid. Engines that wrapped one module would therefore all
    move at a swap of any one of them, and a rolling swap could never
    hold a mixed fleet, gate one replica or roll it back alone. So each
    replica past the first gets its own copy: 13.48 GB of device memory
    per extra Llama-2-7B bf16 replica, where the JAX package's replicas
    share one parameter snapshot until a swap moves one of them."""
    with torch.no_grad():
        return copy.deepcopy(model)


class ReplicaSet:
    """N `InferenceEngine` replicas of the same model weights —
    independent slot pools and independent captured graphs.
    `breaker_kwargs` feeds every replica's CircuitBreaker (tests inject
    clocks/thresholds here).

    Replica 0 serves the caller's `model`; every further replica serves
    its own copy of it (`replica_model`), on the same device, so a
    weight swap moves one replica only (the JAX replicas share one
    parameter snapshot). The JAX `ReplicaSet` preloads its program store
    for the fleet; the port has no program store, and each replica
    captures its own CUDA graphs at first use."""

    def __init__(self, model, num_replicas: int = 2,
                 breaker_kwargs: Optional[dict] = None, **engine_kwargs):
        if num_replicas < 1:
            raise ValueError('num_replicas must be >= 1')
        self.replicas: List[Replica] = []
        for i in range(int(num_replicas)):
            eng = InferenceEngine(model if i == 0 else replica_model(model),
                                  **engine_kwargs)
            self.replicas.append(Replica(
                i, eng, CircuitBreaker(name=str(i),
                                       **(breaker_kwargs or {}))))

    def __len__(self):
        return len(self.replicas)

    def __iter__(self):
        return iter(self.replicas)

    def __getitem__(self, i) -> Replica:
        return self.replicas[i]


class RouterHandle:
    """Router-level view of one ACCEPTED request. Proxies the live
    engine handle; survives failover (the inner handle is replaced and
    the request re-decodes deterministically from its prompt — greedy
    and seeded-sampling tokens are bit-identical to an undisturbed
    run). `status` is FAILED only with a typed error attached; accepted
    requests never dangle."""

    def __init__(self, router: 'Router', prompt_tokens: List[int],
                 params: SamplingParams, tenant: str, priority: int,
                 adapter_id: Optional[str] = None):
        self.router_id = next(_router_ids)
        self.prompt_tokens = list(prompt_tokens)
        self.params = params
        self.tenant = tenant
        self.priority = int(priority)
        # the LoRA adapter this request decodes under (None = base);
        # failover resubmits carry it, so the re-decoded response runs
        # under the same adapter id on the target replica
        self.adapter_id = adapter_id
        self.failovers = 0
        self.inner: Optional[RequestHandle] = None
        self.replica_id: Optional[int] = None
        self._router = router
        self._error: Optional[BaseException] = None
        self._finalized = False
        self._t_submit = time.perf_counter()
        self._t_first: Optional[float] = None
        # the per-request latency ledger record: adopted from the FIRST
        # engine placement (rebased to router submit so QoS/pick time
        # books as admission) and carried across failovers — one
        # waterfall spans replicas
        self._ledger_rec = None

    @property
    def tokens(self) -> List[int]:
        return self.inner.tokens if self.inner is not None else []

    @property
    def weight_version(self) -> Optional[int]:
        """The single weight version this response decodes under
        (stamped at engine admission). Failover replaces the inner
        handle and RE-decodes the whole response on the target replica,
        so the tag — like the tokens — is always the live attempt's:
        never mixed within one response."""
        return (self.inner.weight_version if self.inner is not None
                else None)

    @property
    def adapter_version(self) -> Optional[int]:
        """The adapter version the live attempt decodes under (pinned
        at engine admission; None for base requests or while queued).
        Like `weight_version`, failover re-decodes on the target
        replica, so the tag is always the live attempt's."""
        return (self.inner.adapter_version if self.inner is not None
                else None)

    @property
    def status(self) -> str:
        if self._error is not None:
            return FAILED
        return self.inner.status if self.inner is not None else QUEUED

    @property
    def error(self) -> Optional[BaseException]:
        if self._error is not None:
            return self._error
        return self.inner.error if self.inner is not None else None

    @property
    def done(self) -> bool:
        return self.status in (FINISHED, FAILED)

    @property
    def ttft(self) -> Optional[float]:
        """Seconds from ROUTER submit to the first observed token
        (failover does not reset it — the client's clock never
        restarts)."""
        if self._t_first is None:
            return None
        return self._t_first - self._t_submit

    def stream(self):
        """Per-token iterator driving the whole router (all replicas
        advance; failover happens under the hood). After a failover the
        re-decoded prefix is identical, so the cursor just waits for
        the new inner handle to catch up — no token is yielded twice."""
        cursor = 0
        while True:
            toks = self.tokens
            while cursor < len(toks):
                yield toks[cursor]
                cursor += 1
                toks = self.tokens
            if self.done:
                if self.status == FAILED:
                    raise self.error
                return
            self._router.step()

    def result(self) -> List[int]:
        """Drive the router until this request finishes; returns its
        tokens, or raises its typed error."""
        for _ in self.stream():
            pass
        return self.tokens

    def __repr__(self):
        return (f'RouterHandle(id={self.router_id}, tenant={self.tenant},'
                f' status={self.status}, replica={self.replica_id}, '
                f'failovers={self.failovers}, tokens={len(self.tokens)})')


class Router:
    """Health-checked, load-aware front of a `ReplicaSet`.

    Args:
        replicas: a ReplicaSet (or a plain sequence of Replica).
        tenants: TenantRegistry | {name: spec-dict} | CLI spec string |
            None (everyone is the default tenant: unlimited, NORMAL).
        max_failovers: per-request resubmission budget across replica
            failures; past it the request FAILs with `ReplicaFailure`.
        classify: transient/fatal judgment for failover decisions
            (default `resilience.retry.is_transient` — walks the
            exception chain).
        shed_queue_depth: total queued requests (across replicas) past
            which sheddable work is rejected (None = no depth shedding).
        ttft_budget_s: estimated-TTFT budget; when the queue would make
            a new request wait longer than this, sheddable work is
            rejected (None = off; the estimate is queue/replicas *
            observed round time, so it needs a few rounds of history).
        shed_priority: MINIMUM priority class that may be shed
            (default PRIORITY_LOW: only best-effort work sheds; set
            PRIORITY_NORMAL to protect only 'high').
        retry_after_s: the default `retry_after_s` hint when no better
            estimate exists.
        storm_threshold/storm_window_s: failover-storm detector — this
            many failovers inside the window emits
            `router_failover_storm` (a flight-recorder trigger).
        signal_window_s: width of the sliding signal windows (TTFT
            quantiles, queue depth, shed rate) behind
            `window_signals()` and the `paddle_ttft_p99_window`-family
            gauges — the autoscaler's control inputs. Cumulative
            per-request TTFT can't drive a control loop (an hour of
            history swamps the last 30 seconds); these age out by the
            clock.
    """

    # the replica map is mutated by scale actions (add_replica /
    # remove_replica, possibly on an operator/autoscaler thread) and
    # read per reap round and per stats() call (the /summary scrape
    # thread) — declared to the concurrency sanitizer so any access
    # outside `_lock` after the router is shared across threads is a
    # lockset-race report
    _by_id = _concurrency.guarded_by('_lock', mutable=True)

    def __init__(self, replicas, tenants=None, max_failovers: int = 2,
                 classify: Optional[Callable[[BaseException], bool]] = None,
                 shed_queue_depth: Optional[int] = None,
                 ttft_budget_s: Optional[float] = None,
                 shed_priority: int = PRIORITY_LOW,
                 retry_after_s: float = 1.0,
                 storm_threshold: int = 3, storm_window_s: float = 60.0,
                 signal_window_s: float = 30.0):
        if isinstance(replicas, ReplicaSet):
            self.replicas = list(replicas)
        else:
            self.replicas = list(replicas)
        if not self.replicas:
            raise ValueError('router needs at least one replica')
        # guards replica-set mutation (add/remove/drain) against the
        # per-round reap reads and the stats()/scrape readers; RLock so
        # a locked scale action may refresh gauges (which re-reads)
        self._lock = _concurrency.RLock('Router._lock')
        self._by_id = {r.id: r for r in self.replicas}
        if isinstance(tenants, TenantRegistry):
            self.tenants = tenants
        elif isinstance(tenants, str):
            self.tenants = parse_tenant_spec(tenants)
        elif isinstance(tenants, dict):
            self.tenants = TenantRegistry(tenants)
        else:
            self.tenants = TenantRegistry()
        self.max_failovers = int(max_failovers)
        self.classify = classify or is_transient
        self.shed_queue_depth = shed_queue_depth
        self.ttft_budget_s = ttft_budget_s
        self.shed_priority = int(shed_priority)
        self.retry_after_s = float(retry_after_s)
        self.storm_threshold = int(storm_threshold)
        self.storm_window_s = float(storm_window_s)
        self._live: List[RouterHandle] = []
        self._rounds = 0
        self._ema_round_s: Optional[float] = None
        self._failover_times: collections.deque = collections.deque(
            maxlen=max(self.storm_threshold, 8))
        self._last_storm_t: Optional[float] = None
        self._counts = collections.Counter()
        # replica ids are NEVER reused: a removed replica's scoped
        # degraded states ('replica:N' draining) must not bleed onto a
        # later arrival that would otherwise inherit its id
        self._next_rid = max(r.id for r in self.replicas) + 1
        # sliding signal windows (autoscaler inputs + *_window gauges)
        self.signal_window_s = float(signal_window_s)
        self._win_ttft = _obs.SlidingWindow(self.signal_window_s)
        self._win_queue = _obs.SlidingWindow(self.signal_window_s)
        self._win_shed = _obs.SlidingWindow(self.signal_window_s)
        self._win_accept = _obs.SlidingWindow(self.signal_window_s)
        # queue-depth samples must be uniform in TIME, not per step: an
        # idle router steps thousands of times a second while a
        # backlogged one steps tens, so per-step sampling drowns the
        # backlog in idle zeros and the window quantiles lie
        self._queue_sample_interval = self.signal_window_s / 128.0
        self._last_queue_sample = float('-inf')
        self._init_metrics()

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------
    def _init_metrics(self):
        reg = _obs.get_registry()
        self._m_requests = reg.counter(
            'paddle_router_requests_total',
            'router requests by tenant and outcome',
            ('tenant', 'outcome'))
        self._m_failovers = reg.counter(
            'paddle_router_failovers_total',
            'requests resubmitted after a replica failure', ('replica',))
        self._m_shed = reg.counter(
            'paddle_router_shed_total',
            'admissions rejected fast, by tenant and reason',
            ('tenant', 'reason'))
        self._m_replicas = reg.gauge(
            'paddle_router_replicas', 'replicas behind the router')
        self._m_available = reg.gauge(
            'paddle_router_available_replicas',
            'replicas currently accepting placements')
        self._m_queue = reg.gauge(
            'paddle_router_queue_depth',
            'queued requests summed across replicas')
        self._m_outstanding = reg.gauge(
            'paddle_router_outstanding_tokens',
            'decode tokens owed to accepted requests, per replica',
            ('replica',))
        self._m_ttft = reg.histogram(
            'paddle_router_ttft_seconds',
            'router submit -> first token, by priority class',
            ('priority',))
        self._m_breaker = reg.gauge(
            'paddle_router_breaker_state',
            'breaker state per replica (0 closed, 1 half-open, 2 open)',
            ('replica',))
        self._m_weight_version = reg.gauge(
            'paddle_router_weight_version',
            'weight version each replica is serving (mixed values = '
            'rolling swap in flight)', ('replica',))
        # sliding-window signal gauges: what the cumulative families
        # above cannot say — "what does traffic look like RIGHT NOW" —
        # published so an autoscaler (or a dashboard alarm) can act on
        # /metrics alone
        self._m_ttft_p50_w = reg.gauge(
            'paddle_ttft_p50_window',
            'router TTFT p50 (seconds) over the sliding signal window')
        self._m_ttft_p99_w = reg.gauge(
            'paddle_ttft_p99_window',
            'router TTFT p99 (seconds) over the sliding signal window')
        self._m_queue_p50_w = reg.gauge(
            'paddle_queue_depth_p50_window',
            'fleet queue-depth p50 over the sliding signal window')
        self._m_queue_p99_w = reg.gauge(
            'paddle_queue_depth_p99_window',
            'fleet queue-depth p99 over the sliding signal window')
        self._m_shed_window = reg.gauge(
            'paddle_shed_rate_window',
            'admissions shed per second over the sliding signal window')
        if _obs.enabled():
            self._m_replicas.set(len(self.replicas))
            self._refresh_gauges()

    def _refresh_gauges(self):
        if not _obs.enabled():
            return
        avail = 0
        depth = 0
        for r in self.replicas:
            if not r.health_states() and r.breaker.state != BREAKER_OPEN:
                avail += 1
            depth += r.engine.scheduler.queue_depth
            self._m_outstanding.labels(replica=r.id).set(
                r.outstanding_tokens())
            self._m_breaker.labels(replica=r.id).set(
                _BREAKER_GAUGE[r.breaker.state])
            self._m_weight_version.labels(replica=r.id).set(
                r.engine.weight_version)
        self._m_available.set(avail)
        self._m_queue.set(depth)
        sig = self.window_signals()
        if sig['ttft_p50'] is not None:
            self._m_ttft_p50_w.set(sig['ttft_p50'])
            self._m_ttft_p99_w.set(sig['ttft_p99'])
        if sig['queue_p50'] is not None:
            self._m_queue_p50_w.set(sig['queue_p50'])
            self._m_queue_p99_w.set(sig['queue_p99'])
        self._m_shed_window.set(sig['shed_rate'])

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return sum(r.engine.scheduler.queue_depth for r in self.replicas)

    def _estimated_ttft_s(self) -> Optional[float]:
        """Queue wait estimate for a NEW request: rounds of queued work
        ahead of it divided over serving replicas, times the observed
        round time. Chunking-aware: on a chunked-prefill engine each
        queued prompt costs ceil(prompt/chunk) CHEAP rounds (the round
        time the EMA observes is chunk-bounded), not one whole-prompt
        prefill — charging full prefills against chunk-sized round
        times would over-fire the shed budget. None until a round has
        been timed."""
        if self._ema_round_s is None:
            return None
        serving = sum(1 for r in self.replicas
                      if not r.health_states()
                      and r.breaker.state != BREAKER_OPEN) or 1
        rounds = sum(
            estimate_queue_rounds(
                (len(h.prompt_tokens)
                 for h in r.engine.scheduler.pending()),
                r.engine.prefill_chunk_tokens)
            for r in self.replicas)
        return (rounds / serving + 1) * self._ema_round_s

    def _reject(self, tenant: str, reason: str,
                retry_after: Optional[float], detail: str = '',
                depth_guard: Optional[int] = None):
        self._counts[f'rejected_{reason}'] += 1
        # shed-accounting invariant: a request rejected at
        # admission was never handed to any engine, so the fleet
        # queue-depth signal — which the autoscaler reads as DEMAND —
        # must be exactly what it was when this submission arrived.
        # Double-counting rejected work as demand would make a burst
        # that is being correctly shed look like a reason to scale up.
        if depth_guard is not None:
            depth_now = self.queue_depth
            assert depth_now == depth_guard, (
                f'shed accounting violated: queue depth moved '
                f'{depth_guard} -> {depth_now} while rejecting '
                f'({reason}) — a rejected request leaked into a '
                f'replica queue')
        if reason in ('shed', 'no_healthy_replica'):
            # capacity sheds (not per-tenant policy rejects like
            # rate_limited): the windowed shed-rate signal feeds the
            # autoscaler's scale-up decision
            self._win_shed.mark()
        if _obs.enabled():
            self._m_requests.labels(tenant=tenant, outcome=reason).inc()
            self._m_shed.labels(tenant=tenant, reason=reason).inc()
        raise AdmissionRejected(tenant, reason, retry_after, detail)

    def submit(self, prompt, params: Optional[SamplingParams] = None,
               tenant: Optional[str] = None,
               priority: Optional[int] = None,
               adapter_id: Optional[str] = None, **kwargs) -> RouterHandle:
        """Admit one request for `tenant` (QoS checks first — a
        rejection is synchronous, typed, and consumed NO model work),
        then place it on the least-loaded healthy replica. Returns the
        live RouterHandle; raises `AdmissionRejected` (with
        `retry_after_s`) on rate limit / concurrency cap / load shed /
        adapter unavailable / no healthy replica, or ValueError on
        malformed requests. `adapter_id` names the LoRA adapter the
        request decodes under; unset, the tenant's default `adapter`
        (if any) applies."""
        if params is None:
            params = SamplingParams(**kwargs)
        elif kwargs:
            raise TypeError('pass params= or keyword sampling args, '
                            'not both')
        t = self.tenants.get(tenant)
        prio = int(priority) if priority is not None else t.priority
        if adapter_id is None:
            adapter_id = t.adapter
        # snapshot for the shed-accounting invariant: any rejection
        # below must leave the fleet queue depth exactly here
        depth0 = self.queue_depth

        # 0. adapter availability: fail FAST and typed before any QoS
        # token is spent — a request for a missing adapter can never
        # succeed, so it must not consume a rate-bucket token either
        if adapter_id is not None:
            for r in self.replicas:
                bank = getattr(r.engine, 'adapter_bank', None)
                if bank is None:
                    self._reject(t.name, 'adapter_unavailable', None,
                                 f'adapter {adapter_id!r} requested but '
                                 f'replica {r.id} serves no adapter bank',
                                 depth_guard=depth0)
                if not bank.available(adapter_id):
                    self._reject(
                        t.name, 'adapter_unavailable', None,
                        f'adapter {adapter_id!r} is not resident on '
                        f'replica {r.id} and has no servable store '
                        f'version', depth_guard=depth0)

        # 1. per-tenant token-bucket rate
        if t.bucket is not None and not t.bucket.try_acquire():
            self._reject(t.name, 'rate_limited', t.bucket.retry_after(),
                         f'rate {t.bucket.rate}/s exceeded',
                         depth_guard=depth0)
        # 2. per-tenant concurrency cap
        if (t.max_concurrency is not None
                and t.in_flight >= t.max_concurrency):
            est = self._estimated_ttft_s()
            self._reject(t.name, 'concurrency',
                         est if est is not None else self.retry_after_s,
                         f'{t.in_flight} in flight >= cap '
                         f'{t.max_concurrency}',
                         depth_guard=depth0)
        # 3. load shedding: overload rejects sheddable work FAST
        if prio >= self.shed_priority:
            est = self._estimated_ttft_s()
            depth_over = (self.shed_queue_depth is not None
                          and self.queue_depth >= self.shed_queue_depth)
            ttft_over = (self.ttft_budget_s is not None
                         and est is not None
                         and est > self.ttft_budget_s)
            if depth_over or ttft_over:
                reason_bits = []
                if depth_over:
                    reason_bits.append(
                        f'queue {self.queue_depth} >= '
                        f'{self.shed_queue_depth}')
                if ttft_over:
                    reason_bits.append(
                        f'est ttft {est:.3f}s > {self.ttft_budget_s}s')
                _obs.emit('request_shed', tenant=t.name, priority=prio,
                          queue_depth=self.queue_depth,
                          detail='; '.join(reason_bits))
                self._counts['shed'] += 1
                self._reject(
                    t.name, 'shed',
                    est if est is not None else self.retry_after_s,
                    '; '.join(reason_bits), depth_guard=depth0)
        # 4. placement on the least-loaded healthy replica
        replica = self._pick_replica()
        if replica is None:
            self._reject(t.name, 'no_healthy_replica',
                         self.retry_after_s,
                         'every replica is degraded or circuit-broken',
                         depth_guard=depth0)

        rh = RouterHandle(self, InferenceEngine._normalize_prompt(prompt),
                          params, t.name, prio, adapter_id=adapter_id)
        try:
            self._place(rh, replica)
        except RuntimeError:
            # the pick->place race: the chosen replica began draining
            # (autoscaler scale-down, preemption) after the health check.
            # One re-pick excluding it; if nobody else is healthy the
            # caller gets the TYPED rejection every other capacity path
            # produces, never a bare engine RuntimeError.
            replica = self._pick_replica(exclude=(replica,))
            if replica is None:
                self._reject(t.name, 'no_healthy_replica',
                             self.retry_after_s,
                             'every replica is degraded, draining, or '
                             'circuit-broken', depth_guard=depth0)
            self._place(rh, replica)
        t.in_flight += 1
        self._win_accept.mark()
        self._live.append(rh)
        self._counts['accepted'] += 1
        if _obs.enabled():
            self._m_requests.labels(tenant=t.name,
                                    outcome='accepted').inc()
            self._refresh_gauges()
        return rh

    def _pick_replica(self, exclude: Sequence[Replica] = ()
                      ) -> Optional[Replica]:
        best = None
        for r in self.replicas:
            if r in exclude or r.health_states() or not r.breaker.admits():
                continue
            score = (r.outstanding_tokens(), r.id)
            if best is None or score < best[0]:
                best = (score, r)
        return best[1] if best else None

    def _place(self, rh: RouterHandle, replica: Replica):
        if replica.breaker.state == BREAKER_HALF_OPEN:
            replica.breaker.begin_probe()   # this request IS the probe
        rh.inner = replica.engine.submit(rh.prompt_tokens, rh.params,
                                         priority=rh.priority,
                                         adapter_id=rh.adapter_id)
        rh.replica_id = replica.id
        rec = rh._ledger_rec
        if rec is None:
            # first placement: adopt the record engine.submit opened,
            # re-anchored at ROUTER submit — the tenancy/QoS checks and
            # replica pick in between book as admission
            rec = getattr(rh.inner, '_ledger_rec', None)
            if rec is not None:
                rec.rebase_submit(rh._t_submit)
                rec.tenant = rh.tenant
                rh._ledger_rec = rec
        else:
            # failover: drop the fresh record this submit opened and
            # keep the ORIGINAL following the request — the waterfall
            # spans replicas
            rh.inner._ledger_rec = rec
            rec.failovers = rh.failovers
        if rec is not None:
            rec.replica_id = replica.id

    # ------------------------------------------------------------------
    # the iteration loop
    # ------------------------------------------------------------------
    def step(self) -> int:
        """ONE fleet iteration: advance every replica that has work
        (degraded replicas still DRIVE their in-flight requests — they
        just receive no new placements), fail over anything a dying
        replica drops, retire finished requests. Returns the number of
        requests that progressed."""
        progressed = 0
        t0 = time.perf_counter()
        stepped = False
        for r in list(self.replicas):
            if not r.engine.has_work:
                continue
            try:
                progressed += r.engine.step()
                stepped = True
            except BaseException as exc:
                self._on_replica_failure(r, exc)
        if stepped:
            dt = time.perf_counter() - t0
            self._ema_round_s = (dt if self._ema_round_s is None
                                 else 0.8 * self._ema_round_s + 0.2 * dt)
        self._reap()
        self._rounds += 1
        # windowed demand sample: ACCEPTED queued work only, observed
        # after admission/reaping — never inside the submit path, so a
        # burst of shed submissions cannot pump the demand signal —
        # and throttled to a time-uniform cadence (see __init__)
        now_m = time.monotonic()
        if now_m - self._last_queue_sample >= self._queue_sample_interval:
            self._last_queue_sample = now_m
            self._win_queue.observe(self.queue_depth)
        # gauges are monitoring, not control flow: refreshing every 8th
        # round keeps the per-round router cost out of the decode path
        # (submit/finalize still refresh immediately where it matters)
        if _obs.enabled() and (self._rounds % 8 == 0 or not self._live):
            self._refresh_gauges()
        return progressed

    def run(self) -> int:
        """Drive until every accepted request is FINISHED or FAILED;
        returns the number of router iterations."""
        rounds = 0
        while self._live:
            progressed = self.step()
            rounds += 1
            if (not progressed and self._live
                    and not any(r.engine.has_work for r in self.replicas)):
                # defensive: a handle with no engine work behind it is a
                # router bug — fail it typed rather than spin forever
                for rh in self._live:
                    rh._error = ReplicaFailure(
                        rh.replica_id if rh.replica_id is not None else -1,
                        'request stranded with no engine work (router '
                        'invariant violated)')
                self._reap()
                break
        return rounds

    def _reap(self):
        now = time.perf_counter()
        still: List[RouterHandle] = []
        for rh in self._live:
            if (rh._t_first is None and rh.inner is not None
                    and rh.inner.tokens):
                rh._t_first = now
                self._win_ttft.observe(now - rh._t_submit)
            with self._lock:
                replica = self._by_id.get(rh.replica_id)
            if rh._error is not None:
                self._finalize(rh, 'failed')
            elif rh.inner is not None and rh.inner.status == FINISHED:
                if replica is not None:
                    replica.breaker.record_success()
                self._finalize(rh, 'completed')
                if _obs.enabled() and rh.ttft is not None:
                    self._m_ttft.labels(priority=rh.priority).observe(
                        rh.ttft)
            elif rh.inner is not None and rh.inner.status == FAILED:
                # request-level failure (engine already classified and
                # retried transients; this is final) — typed, not lost
                rh._error = rh.inner.error
                if (replica is not None
                        and replica.breaker.state == BREAKER_HALF_OPEN):
                    replica.breaker.record_failure()   # failed probe
                self._finalize(rh, 'failed')
            else:
                still.append(rh)
        self._live = still

    def _finalize(self, rh: RouterHandle, outcome: str):
        if rh._finalized:
            return
        rh._finalized = True
        self.tenants.get(rh.tenant).in_flight -= 1
        self._counts[outcome] += 1
        if rh.inner is not None and rh.inner._ledger_rec is not None:
            # completed/engine-failed requests already closed their
            # record via the handle hooks (finalize is idempotent);
            # this catches router-level failures (_error set with the
            # inner handle merely evicted, never failed)
            from ..observability import reqledger as _reqledger
            _reqledger.get_ledger().finalize(rh.inner, outcome=outcome)
        if _obs.enabled():
            self._m_requests.labels(tenant=rh.tenant,
                                    outcome=outcome).inc()

    # ------------------------------------------------------------------
    # failover
    # ------------------------------------------------------------------
    def _on_replica_failure(self, replica: Replica, exc: BaseException):
        """A replica failed mid-step: open-circuit accounting, evict its
        accepted requests, resubmit the ones the classifier deems
        recoverable (bounded per request), fail the rest typed."""
        replica.failures += 1
        replica.breaker.record_failure()
        orphans = replica.engine.evict_all()
        by_inner = {id(rh.inner): rh for rh in self._live
                    if rh.inner is not None}
        _obs.emit('router_failover', replica=replica.id,
                  error=type(exc).__name__, orphans=len(orphans))
        self._note_failover_storm()
        if _obs.enabled():
            self._m_failovers.labels(replica=replica.id).inc(
                len(orphans) or 1)
        transient = self.classify(self._wrap(replica, exc))
        for h in orphans:
            rh = by_inner.get(id(h))
            if rh is None:
                continue   # an engine-level handle the router never saw
            rec = rh._ledger_rec
            t_det = time.perf_counter()
            if rec is not None:
                if rec._q_mark is not None:
                    # the victim was still queued on the dead replica:
                    # its wait so far stays queue_wait
                    rec.queue_exit(t_det)
                else:
                    # mid-decode victim: the gap since its last round
                    # IS the failure-detection window
                    rec.add('failover_resubmit',
                            t_det - rec._last_touch, now=t_det)
            err = self._wrap(replica, exc)
            if not transient or rh.failovers >= self.max_failovers:
                rh._error = err
                continue
            target = self._pick_replica(exclude=(replica,))
            if target is None:
                if rec is not None:
                    # time from here to the failed-request reap books
                    # under the reason the victim actually died of
                    rec.queue_enter(t_det, 'no_healthy_replica')
                rh._error = ReplicaFailure(
                    replica.id,
                    f'replica {replica.id} failed and no healthy '
                    f'replica remains for failover')
                rh._error.__cause__ = exc
                continue
            rh.failovers += 1
            try:
                self._place(rh, target)
            except BaseException as place_exc:
                rh._error = ReplicaFailure(
                    target.id,
                    f'failover resubmission to replica {target.id} '
                    f'failed: {place_exc}')
                rh._error.__cause__ = place_exc
                continue
            if rec is not None:
                # re-placement work (re-submit incl. prompt re-prep on
                # the target) books as failover_resubmit, then the
                # request re-queues — behind the survivor's own load,
                # or breaker-gated if the target is probing
                t2 = time.perf_counter()
                rec.add('failover_resubmit', t2 - t_det, now=t2)
                rec.queue_enter(
                    t2, 'breaker_open' if not replica.breaker.admits()
                    else 'priority_queued')

    @staticmethod
    def _wrap(replica: Replica, exc: BaseException) -> ReplicaFailure:
        err = ReplicaFailure(
            replica.id,
            f'replica {replica.id} failed mid-flight: '
            f'{type(exc).__name__}: {exc}')
        err.__cause__ = exc   # the classifier walks this chain
        return err

    def _note_failover_storm(self):
        now = time.monotonic()
        self._failover_times.append(now)
        if len(self._failover_times) < self.storm_threshold:
            return
        window = now - self._failover_times[-self.storm_threshold]
        if window > self.storm_window_s:
            return
        if (self._last_storm_t is not None
                and now - self._last_storm_t < self.storm_window_s):
            return   # one storm event per window
        self._last_storm_t = now
        _obs.emit('router_failover_storm',
                  failovers=len(self._failover_times),
                  window_s=round(window, 3))

    # ------------------------------------------------------------------
    # windowed signals (the autoscaler's control inputs)
    # ------------------------------------------------------------------
    def serving_replica_count(self) -> int:
        """Replicas currently accepting placements (healthy, breaker
        not open). Draining replicas still DRIVE their work but count
        as leaving capacity."""
        return sum(1 for r in self.replicas
                   if not r.health_states()
                   and r.breaker.state != BREAKER_OPEN)

    def window_signals(self) -> dict:
        """One consistent snapshot of the sliding-window control
        signals: TTFT p50/p99 (None before the first in-window first
        token), fleet queue-depth p50/p99 over the per-step samples
        (None before the first routed step), capacity-shed rate and
        accept rate (requests/second), and the serving replica count.
        This — not the cumulative `paddle_router_*` families — is what
        the autoscaler polls: every value ages out of the window by the
        clock, so a burst that ended a minute ago stops arguing for
        more replicas."""
        return {
            'window_s': self.signal_window_s,
            'ttft_p50': self._win_ttft.quantile(0.50),
            'ttft_p99': self._win_ttft.quantile(0.99),
            'queue_p50': self._win_queue.quantile(0.50),
            'queue_p99': self._win_queue.quantile(0.99),
            'shed_rate': self._win_shed.rate(),
            'accept_rate': self._win_accept.rate(),
            'serving_replicas': self.serving_replica_count(),
        }

    # ------------------------------------------------------------------
    # operations
    # ------------------------------------------------------------------
    def add_replica(self, engine: InferenceEngine,
                    breaker_kwargs: Optional[dict] = None) -> Replica:
        """Join a freshly provisioned engine to the fleet under a new —
        never recycled — replica id (a removed replica's scoped
        degraded states must not bleed onto a later arrival). The
        engine should come from the same weights/geometry as its
        siblings, over a model of its own (`replica_model`); it captures
        its graphs at first use. Returns the new Replica, immediately
        eligible for placement."""
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            r = Replica(rid, engine,
                        CircuitBreaker(name=str(rid),
                                       **(breaker_kwargs or {})))
            self.replicas.append(r)
            self._by_id[rid] = r
        if _obs.enabled():
            self._m_replicas.set(len(self.replicas))
            self._refresh_gauges()
        return r

    def remove_replica(self, rid: int) -> Replica:
        """Detach a DRAINED replica from the fleet (the scale-down
        endpoint: `drain_replica` first, keep stepping until its engine
        has no work, then remove). Refuses while the engine still holds
        accepted work — removal must never drop a request — and clears
        the replica's scoped `draining` health state so /healthz
        converges once the replica is gone."""
        with self._lock:
            r = self._by_id[rid]
            if r.engine.has_work:
                raise RuntimeError(
                    f'replica {rid} still holds accepted work '
                    f'(queued={r.engine.scheduler.queue_depth}, '
                    f'in_flight={len(r.engine._slot_req)}); drain it '
                    f'before removing')
            if len(self.replicas) <= 1:
                raise RuntimeError('refusing to remove the last replica')
            del self._by_id[rid]
            self.replicas.remove(r)
        _obs.clear_degraded('draining', scope=r.scope, force=True)
        if _obs.enabled():
            self._m_replicas.set(len(self.replicas))
            self._refresh_gauges()
        return r

    def drain_replica(self, rid: int):
        """Take replica `rid` out of rotation NOW (runbook: rolling
        restart / eviction). Its scoped `draining` state excludes it
        from placement immediately; router steps keep driving its
        accepted requests to completion. Returns the replica."""
        with self._lock:
            r = self._by_id[rid]
        r.engine.begin_drain()
        return r

    def generate_many(self, prompts, params=None, tenant=None,
                      priority=None,
                      adapter_id: Optional[str] = None
                      ) -> List[RouterHandle]:
        """Submit a batch and drive the fleet dry (the router analogue
        of `InferenceEngine.generate_many`)."""
        if params is None or isinstance(params, SamplingParams):
            params = [params or SamplingParams()] * len(prompts)
        if len(params) != len(prompts):
            raise ValueError('one SamplingParams per prompt')
        handles = [self.submit(p, sp, tenant=tenant, priority=priority,
                               adapter_id=adapter_id)
                   for p, sp in zip(prompts, params)]
        self.run()
        return handles

    def stats(self) -> dict:
        """Router-level counters + a per-replica health/load snapshot
        (the chaos tests' 'none dangle' assertions read this)."""
        per_replica = []
        # snapshot under the fleet lock: stats() runs on scrape threads
        # while add_replica/remove_replica resize the list
        with self._lock:
            replicas = list(self.replicas)
        for r in replicas:
            per_replica.append({
                'id': r.id,
                'breaker': r.breaker.state,
                'health_states': sorted(r.health_states()),
                'outstanding_tokens': r.outstanding_tokens(),
                'queued': r.engine.scheduler.queue_depth,
                'active_slots': len(r.engine._slot_req),
                'failures': r.failures,
                'weight_version': r.engine.weight_version,
            })
        return {
            'accepted': self._counts['accepted'],
            'completed': self._counts['completed'],
            'failed': self._counts['failed'],
            'shed': self._counts['shed'],
            'rejected': {k[len('rejected_'):]: v
                         for k, v in self._counts.items()
                         if k.startswith('rejected_')},
            'in_flight': len(self._live),
            'queue_depth': self.queue_depth,
            'replicas': per_replica,
            'tenants': {name: {'in_flight': t.in_flight, **t.spec()}
                        for name, t in self.tenants.tenants().items()},
        }
