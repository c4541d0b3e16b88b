"""Per-tenant QoS: priorities, token-bucket rate limits, concurrency caps
(a copy of `paddle_tpu/serving/tenancy.py`; stdlib only).

A production serving fleet never runs one anonymous traffic stream —
it runs tenants (users, API keys, internal jobs) with different
entitlements, and overload policy is defined in tenant terms: paid
traffic is protected, best-effort traffic is shed FAST (a rejected
request that cost nothing is infinitely better than an accepted one
that times out — the classic load-shedding doctrine). This module is
the data model the router enforces:

- `Tenant` — a name plus its QoS envelope: priority class
  (api.PRIORITY_HIGH/NORMAL/LOW → the scheduler's admission key),
  a request-rate `TokenBucket` (rate/burst; None = unlimited), a
  `max_concurrency` cap on in-flight requests (None = unlimited), and
  an optional default `adapter` — the LoRA adapter id the tenant's
  requests decode under (serving.adapters.AdapterBank; per-request
  adapter_id overrides it). Concurrency caps double as capacity
  reservations: capping best-effort tenants below the slot count keeps
  slots free for latency-sensitive ones, which is what makes
  "high-priority TTFT unaffected by overload" a structural guarantee
  rather than a hope.
- `TenantRegistry` — name -> Tenant with a default template for unknown
  tenants (each still gets its OWN bucket/accounting).
- `AdmissionRejected` — the typed fast-fail: tenant, reason
  ('rate_limited' | 'concurrency' | 'shed' | 'no_healthy_replica' |
  'adapter_unavailable') and a `retry_after_s` hint, raised by the
  router BEFORE any prefill work happens.
- `parse_tenant_spec` — the CLI/env format of the JAX package's
  `examples/serve_gpt.py --tenants`:
      "paid:priority=high,rate=50,burst=100,adapter=paid-v2;free:priority=low,rate=2,concurrency=2"
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from .api import PRIORITY_NAMES, PRIORITY_NORMAL


# the CLOSED vocabulary of typed rejection reasons. Kept in lockstep
# with the request-ledger's BLOCKED_REASONS (a rejected request never
# gets a ledger record — it cost nothing, which is the point — but
# dashboards join the two vocabularies when explaining tail behavior).
REJECT_REASONS = ('rate_limited', 'concurrency', 'shed',
                  'no_healthy_replica', 'adapter_unavailable')


class AdmissionRejected(RuntimeError):
    """Typed admission rejection (rate limit, concurrency cap, load
    shed, or no healthy replica). Always raised synchronously from
    `Router.submit` — the request never consumed a prefill or a slot.
    `retry_after_s` is the router's hint for client backoff."""

    def __init__(self, tenant: str, reason: str,
                 retry_after_s: Optional[float] = None, detail: str = ''):
        if reason not in REJECT_REASONS:
            raise ValueError(
                f'unknown rejection reason {reason!r}; the vocabulary '
                f'is closed: {REJECT_REASONS}')
        self.tenant = tenant
        self.reason = reason
        self.retry_after_s = retry_after_s
        msg = f'tenant {tenant!r} rejected ({reason})'
        if detail:
            msg += f': {detail}'
        if retry_after_s is not None:
            msg += f' [retry after {retry_after_s:.3f}s]'
        super().__init__(msg)


class TokenBucket:
    """Classic token bucket: `rate` tokens/sec refill up to `burst`
    capacity; each admission takes one token. `clock` is injectable so
    tests drive time explicitly."""

    def __init__(self, rate: float, burst: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if rate <= 0:
            raise ValueError('rate must be > 0 tokens/sec')
        self.rate = float(rate)
        self.capacity = float(burst if burst is not None
                              else max(rate, 1.0))
        if self.capacity < 1.0:
            raise ValueError('burst must allow at least one request')
        self._clock = clock
        self._tokens = self.capacity
        self._t = clock()

    def _refill(self):
        now = self._clock()
        self._tokens = min(self.capacity,
                           self._tokens + (now - self._t) * self.rate)
        self._t = now

    def try_acquire(self, n: float = 1.0) -> bool:
        self._refill()
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def retry_after(self, n: float = 1.0) -> float:
        """Seconds until `n` tokens will be available (0 if they are)."""
        self._refill()
        if self._tokens >= n:
            return 0.0
        return (n - self._tokens) / self.rate

    @property
    def tokens(self) -> float:
        self._refill()
        return self._tokens


class Tenant:
    """One tenant's QoS envelope + live accounting (in-flight count)."""

    def __init__(self, name: str, priority: int = PRIORITY_NORMAL,
                 rate: Optional[float] = None,
                 burst: Optional[float] = None,
                 max_concurrency: Optional[int] = None,
                 adapter: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        if isinstance(priority, str):
            try:
                priority = PRIORITY_NAMES[priority.lower()]
            except KeyError:
                raise ValueError(
                    f'unknown priority {priority!r}; expected one of '
                    f'{sorted(PRIORITY_NAMES)} or an int class')
        self.priority = int(priority)
        self.bucket = (TokenBucket(rate, burst, clock=clock)
                       if rate is not None else None)
        self.max_concurrency = (int(max_concurrency)
                                if max_concurrency is not None else None)
        # the tenant's default LoRA adapter (None = base model); the
        # router stamps it onto submissions that don't name their own
        self.adapter = adapter
        self.in_flight = 0

    def spec(self) -> dict:
        return {'priority': self.priority,
                'rate': self.bucket.rate if self.bucket else None,
                'burst': self.bucket.capacity if self.bucket else None,
                'max_concurrency': self.max_concurrency,
                'adapter': self.adapter}

    def __repr__(self):
        return f'Tenant({self.name!r}, {self.spec()})'


DEFAULT_TENANT = 'default'


class TenantRegistry:
    """name -> Tenant. Unknown tenants get their own Tenant cloned from
    the default template (separate bucket + in-flight accounting), so a
    brand-new API key is rate-limited like any other default-tier
    tenant instead of sharing one global bucket."""

    def __init__(self, tenants: Optional[Dict[str, dict]] = None,
                 default: Optional[dict] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._default_spec = dict(default or {})
        self._tenants: Dict[str, Tenant] = {}
        for name, spec in (tenants or {}).items():
            self.add(name, **spec)

    def add(self, name: str, **spec) -> Tenant:
        t = Tenant(name, clock=self._clock, **spec)
        self._tenants[name] = t
        return t

    def get(self, name: Optional[str]) -> Tenant:
        name = name or DEFAULT_TENANT
        t = self._tenants.get(name)
        if t is None:
            t = Tenant(name, clock=self._clock, **self._default_spec)
            self._tenants[name] = t
        return t

    def tenants(self) -> Dict[str, Tenant]:
        return dict(self._tenants)

    def __contains__(self, name: str) -> bool:
        return name in self._tenants


def prefill_rounds(prompt_len: int, chunk_tokens: Optional[int]) -> int:
    """Scheduler iterations a queued prompt occupies before its slot can
    decode: ONE whole-prompt prefill without chunking, else
    ceil(prompt/chunk) bounded chunk rounds. The shed estimator's unit
    of head-of-line delay."""
    if not chunk_tokens or chunk_tokens <= 0:
        return 1
    return max(1, -(-int(prompt_len) // int(chunk_tokens)))


def estimate_queue_rounds(queued_prompt_lens,
                          chunk_tokens: Optional[int] = None) -> float:
    """Rounds of prefill work ahead of a NEW request: queue depth x
    per-prompt chunk rounds — NOT x whole-prompt prefills. With chunked
    prefill enabled, each round is bounded by the chunk bucket, so the
    observed round time stays small and a queued long prompt is many
    CHEAP rounds instead of one expensive one; an estimator that still
    charged a full-prompt prefill per queued request would over-fire the
    shed budget the moment chunking lands (the old behavior)."""
    return float(sum(prefill_rounds(s, chunk_tokens)
                     for s in queued_prompt_lens))


_SPEC_KEYS = {'priority': str, 'rate': float, 'burst': float,
              'concurrency': int, 'max_concurrency': int,
              'adapter': str}


def parse_tenant_spec(spec: str,
                      clock: Callable[[], float] = time.monotonic
                      ) -> TenantRegistry:
    """Parse the CLI tenant-spec format into a TenantRegistry.

    Format: `name:key=value,key=value;name2:...`, keys from
    priority (high|normal|low or int) / rate (req/s) / burst /
    concurrency / adapter (default LoRA adapter id). A bare `name`
    (no colon) gets all defaults.

        parse_tenant_spec('paid:priority=high,rate=50,adapter=paid-ft;'
                          'free:priority=low,rate=2,concurrency=2')
    """
    reg = TenantRegistry(clock=clock)
    for chunk in (spec or '').split(';'):
        chunk = chunk.strip()
        if not chunk:
            continue
        name, _, body = chunk.partition(':')
        name = name.strip()
        if not name:
            raise ValueError(f'tenant spec chunk {chunk!r} has no name')
        kw: dict = {}
        for item in body.split(','):
            item = item.strip()
            if not item:
                continue
            key, eq, value = item.partition('=')
            key = key.strip()
            if not eq or key not in _SPEC_KEYS:
                raise ValueError(
                    f'bad tenant spec item {item!r} for {name!r}; '
                    f'expected key=value with key in '
                    f'{sorted(_SPEC_KEYS)}')
            cast = _SPEC_KEYS[key]
            if key in ('concurrency', 'max_concurrency'):
                kw['max_concurrency'] = int(value)
            elif key == 'priority':
                v = value.strip()
                kw['priority'] = int(v) if v.lstrip('-').isdigit() else v
            elif key == 'adapter':
                kw['adapter'] = value.strip()
            else:
                kw[key] = cast(value)
        reg.add(name, **kw)
    return reg
