"""Goodput-driven autoscaling: grow/shrink the ReplicaSet from the
signals the fleet already publishes (a copy of
`paddle_tpu/serving/autoscaler.py`).

The policy loop over parts the port already has — the router's
windowed TTFT/queue/shed signals and the graceful-drain path that
retires an engine without dropping a request. The `Autoscaler`:

- **Signals, not guesses.** Decisions read `Router.window_signals()`:
  sliding-window TTFT p99 against the SLO, queued-work depth per
  serving replica, and the capacity-shed rate. Windowed — a burst that
  ended a minute ago ages out instead of arguing for more replicas,
  and (the shed-accounting invariant) rejected work never appears as
  demand.
- **Hysteresis + cooldown, so the fleet never flaps.** Scale-up and
  scale-down fire on DIFFERENT thresholds with a dead band between
  them, scale-down additionally requires the quiet signal to have held
  for a full `down_stable_s`, and any action starts a cooldown during
  which the loop only observes. One decision per poll, one replica per
  decision.
- **Provisioning pays — so the decision accounts for it.** Scale-up
  builds the new engine through the caller's factory: in the port a
  fresh engine over its own copy of the weights
  (`router.replica_model`), which captures its CUDA graphs at first use
  (there is no program store to load them from). The measured
  provision latency (the build, plus the captures when the factory
  warms the engine) feeds an EMA, and the post-scale-up
  cooldown is extended by that EMA: while a replica is still warming
  into usefulness, its cost must not be misread as "scale-up didn't
  help, add another".
- **Scale-down drains, never drops.** The victim is cordoned via the
  same `begin_drain` path preemption uses (scoped `draining` excludes
  it from placement; router steps keep finishing its accepted work)
  and is only removed once its engine holds zero work.
- **Every decision is attributable.** Actions emit `autoscale_*`
  events; provisioning runs under the `autoscale.provision` span and
  retirement under `autoscale.retire`, which the goodput ledger books
  as the new `scale_up` / `scale_down` categories — so the bench can
  PROVE the added machinery costs <3% of wall time, with the ledger
  still closing within 1%.

Flags (env-overridable like every FLAGS_*): `FLAGS_autoscale` gates
the loop (`poll()` is a no-op when off unless the autoscaler was built
with `force=True`), `FLAGS_autoscale_min_replicas` /
`FLAGS_autoscale_max_replicas` bound the fleet, and
`FLAGS_autoscale_cooldown_s` is the default decision cooldown.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

from .. import flags as _flags
from .. import observability as _obs
from .engine import InferenceEngine
from .router import Replica, Router

# decision strings poll() returns (and counts per action)
HOLD = 'hold'
HOLD_COOLDOWN = 'hold_cooldown'
HOLD_AT_MAX = 'hold_at_max'
HOLD_AT_MIN = 'hold_at_min'
SCALE_UP = 'scale_up'
SCALE_DOWN = 'scale_down'
DISABLED = 'disabled'


@dataclasses.dataclass
class AutoscalerConfig:
    """Policy knobs. The defaults encode the hysteresis shape, not any
    particular hardware: tune `slo_ttft_s` and the queue thresholds to
    the deployment, keep up-thresholds strictly above down-thresholds
    (validated) so there is always a dead band."""

    min_replicas: int = 1
    max_replicas: int = 4
    #: the latency objective scale decisions are judged against
    slo_ttft_s: float = 1.0
    #: scale up when windowed TTFT p99 exceeds slo * this
    up_ttft_frac: float = 0.8
    #: scale down only while TTFT p99 is under slo * this
    down_ttft_frac: float = 0.3
    #: scale up when windowed p99 queued requests per serving replica
    #: exceeds this — p99, not median, because flash crowds backlog the
    #: queue for a small fraction of the window and a median would
    #: average them away (the router samples queue depth time-uniformly,
    #: so the quantile is over wall time, not over step count)
    up_queue_per_replica: float = 4.0
    #: scale down only while p99 queued per serving replica is under
    #: this — even the window's worst moment must be quiet
    down_queue_per_replica: float = 0.5
    #: any capacity shedding in the window is a scale-up vote
    up_on_shed: bool = True
    #: seconds between decisions (both directions)
    cooldown_s: float = 10.0
    #: extra post-scale-up cooldown per second of measured provision
    #: latency (the provision-latency accounting: a fleet whose
    #: replicas take 30 s to warm must not re-judge demand after 10)
    provision_cooldown_factor: float = 1.0
    #: the quiet signal must hold this long before a scale-down fires
    down_stable_s: float = 10.0

    @classmethod
    def from_flags(cls, **overrides) -> 'AutoscalerConfig':
        base = dict(
            min_replicas=int(_flags.flag('FLAGS_autoscale_min_replicas')),
            max_replicas=int(_flags.flag('FLAGS_autoscale_max_replicas')),
            cooldown_s=float(_flags.flag('FLAGS_autoscale_cooldown_s')))
        base.update(overrides)
        return cls(**base)

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError('need 1 <= min_replicas <= max_replicas')
        if self.slo_ttft_s <= 0:
            raise ValueError('slo_ttft_s must be positive')
        if self.down_ttft_frac >= self.up_ttft_frac:
            raise ValueError('hysteresis requires down_ttft_frac < '
                             'up_ttft_frac (a dead band)')
        if self.down_queue_per_replica >= self.up_queue_per_replica:
            raise ValueError('hysteresis requires down_queue_per_replica '
                             '< up_queue_per_replica (a dead band)')
        if self.cooldown_s < 0 or self.down_stable_s < 0:
            raise ValueError('cooldown_s/down_stable_s must be >= 0')


class Autoscaler:
    """The policy loop. Drive it by calling `poll()` from the serving
    event loop (the LoadReplayer does; a deployment would call it
    between router steps) — it is cheap when nothing changes: one
    window_signals() read and a few comparisons.

    Args:
        router: the Router whose ReplicaSet is managed.
        replica_factory: zero-arg callable returning a fresh
            `InferenceEngine` with the SAME weights/geometry as the
            existing replicas, over a model of its own:
            `lambda: InferenceEngine(replica_model(model), **kw)`, or
            `Supervisor.replica_factory()`, which spawns a replica
            process and returns its `RemoteReplica`.
        config: AutoscalerConfig (default: from flags).
        clock: injectable monotonic clock (tests).
        force: run even while `FLAGS_autoscale` is off (benches that
            A/B the loop explicitly).
        signal_source: optional zero-arg callable returning a
            `window_signals()`-shaped dict: plug in an
            `observability.aggregator.FleetSignalSource` so decisions
            read the fleet view (routers and replicas in other
            processes) instead of the local router's registry. None
            keeps the local read.
    """

    def __init__(self, router: Router,
                 replica_factory: Callable[[], InferenceEngine],
                 config: Optional[AutoscalerConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 force: bool = False,
                 signal_source: Optional[Callable[[], dict]] = None):
        self.router = router
        self.replica_factory = replica_factory
        self.config = config or AutoscalerConfig.from_flags()
        self._clock = clock
        self._force = bool(force)
        self.signal_source = signal_source
        self._cooldown_until: Optional[float] = None
        self._quiet_since: Optional[float] = None
        self._draining: Dict[int, float] = {}    # rid -> drain start
        self._provision_ema_s: Optional[float] = None
        self._decisions: Dict[str, int] = {}
        self._init_metrics()

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------
    def _init_metrics(self):
        reg = _obs.get_registry()
        self._m_replicas = reg.gauge(
            'paddle_autoscaler_replicas',
            'replicas attached to the autoscaled fleet')
        self._m_draining = reg.gauge(
            'paddle_autoscaler_draining_replicas',
            'replicas cordoned and draining toward removal')
        self._m_decisions = reg.counter(
            'paddle_autoscaler_decisions_total',
            'autoscaler poll outcomes by action', ('action',))
        self._m_provision = reg.histogram(
            'paddle_autoscaler_provision_seconds',
            'wall seconds to provision one replica (engine build + '
            'program-store load)')
        self._m_replica_seconds = reg.counter(
            'paddle_autoscaler_replica_seconds_total',
            'integrated replica-seconds of hardware occupancy while '
            'the autoscaler ran')
        if _obs.enabled():
            self._m_replicas.set(len(self.router.replicas))
            self._m_draining.set(0)
        self._last_integrate: Optional[float] = None

    def _count(self, action: str) -> str:
        self._decisions[action] = self._decisions.get(action, 0) + 1
        if _obs.enabled():
            self._m_decisions.labels(action=action).inc()
        return action

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._force or bool(_flags.flag('FLAGS_autoscale'))

    @property
    def provision_ema_s(self) -> Optional[float]:
        """Measured provision-latency EMA (None before the first
        scale-up); feeds the post-scale-up cooldown extension."""
        return self._provision_ema_s

    def active_replicas(self) -> int:
        """Attached and NOT cordoned for removal."""
        return len(self.router.replicas) - len(self._draining)

    def poll(self, now: Optional[float] = None) -> str:
        """One control iteration: finish pending drains, read the
        windowed signals, make at most ONE scaling decision. Returns
        the decision string (metrics count the same names)."""
        if not self.enabled:
            return DISABLED
        now = self._clock() if now is None else now
        self._integrate(now)
        self._advance_drains(now)
        cfg = self.config
        sig = (self.signal_source() if self.signal_source is not None
               else self.router.window_signals())
        want_up, up_why = self._wants_scale_up(sig)
        if self._cooldown_until is not None and now < self._cooldown_until:
            # observe-only window; still note a blocked scale-up WISH so
            # thrash analysis can tell "held by cooldown" from "quiet"
            if want_up:
                return self._count(HOLD_COOLDOWN)
            self._track_quiet(sig, now)
            return self._count(HOLD)
        if want_up:
            self._quiet_since = None
            if self.active_replicas() >= cfg.max_replicas:
                return self._count(HOLD_AT_MAX)
            self._scale_up(now, up_why, sig)
            return self._count(SCALE_UP)
        if self._track_quiet(sig, now) \
                and now - self._quiet_since >= cfg.down_stable_s:
            if self.active_replicas() <= cfg.min_replicas:
                return self._count(HOLD_AT_MIN)
            self._scale_down(now, sig)
            return self._count(SCALE_DOWN)
        return self._count(HOLD)

    # ------------------------------------------------------------------
    # signal interpretation
    # ------------------------------------------------------------------
    def _wants_scale_up(self, sig: dict):
        cfg = self.config
        serving = max(sig['serving_replicas'], 1)
        if cfg.up_on_shed and sig['shed_rate'] > 0:
            return True, f'shedding {sig["shed_rate"]:.2f}/s'
        if sig['ttft_p99'] is not None \
                and sig['ttft_p99'] > cfg.slo_ttft_s * cfg.up_ttft_frac:
            return True, (f'ttft p99 {sig["ttft_p99"]:.3f}s > '
                          f'{cfg.up_ttft_frac:.0%} of SLO')
        if sig['queue_p99'] is not None \
                and sig['queue_p99'] / serving > cfg.up_queue_per_replica:
            return True, (f'queue p99 {sig["queue_p99"]:.1f} over '
                          f'{serving} serving replicas')
        return False, ''

    def _is_quiet(self, sig: dict) -> bool:
        """The scale-down side of the dead band: EVERY signal must sit
        under its (lower) threshold, and the queue signal must actually
        have data — no evidence is not evidence of idleness enough to
        give hardware back on."""
        cfg = self.config
        serving = max(sig['serving_replicas'], 1)
        if sig['shed_rate'] > 0:
            return False
        if sig['ttft_p99'] is not None \
                and sig['ttft_p99'] > cfg.slo_ttft_s * cfg.down_ttft_frac:
            return False
        if sig['queue_p99'] is None:
            return False
        return sig['queue_p99'] / serving <= cfg.down_queue_per_replica

    def _track_quiet(self, sig: dict, now: float) -> bool:
        if self._is_quiet(sig):
            if self._quiet_since is None:
                self._quiet_since = now
            return True
        self._quiet_since = None
        return False

    # ------------------------------------------------------------------
    # actions
    # ------------------------------------------------------------------
    def _scale_up(self, now: float, why: str, sig: dict):
        cfg = self.config
        t0 = self._clock()
        with _obs.span('autoscale.provision'):
            engine = self.replica_factory()
            replica = self.router.add_replica(engine)
        provision_s = self._clock() - t0
        self._provision_ema_s = (
            provision_s if self._provision_ema_s is None
            else 0.5 * self._provision_ema_s + 0.5 * provision_s)
        # provision-latency accounting: demand is not re-judged until
        # the new replica has plausibly warmed into the signal window —
        # anchored at the moment provisioning FINISHED (the provision
        # itself consumed wall time) and extended by the measured
        # provision EMA
        self._cooldown_until = self._clock() + cfg.cooldown_s \
            + cfg.provision_cooldown_factor * self._provision_ema_s
        self._quiet_since = None
        _obs.emit('autoscale_up', replica=replica.id, reason=why,
                  replicas=len(self.router.replicas),
                  provision_s=round(provision_s, 4),
                  ttft_p99=sig['ttft_p99'], queue_p99=sig['queue_p99'],
                  shed_rate=sig['shed_rate'])
        if _obs.enabled():
            self._m_provision.observe(provision_s)
            self._m_replicas.set(len(self.router.replicas))

    def _pick_victim(self) -> Optional[Replica]:
        """Least outstanding work, newest id breaking ties — retiring
        the most recent arrival keeps the longest-warmed replicas."""
        best = None
        for r in self.router.replicas:
            if r.id in self._draining:
                continue
            score = (r.outstanding_tokens(), -r.id)
            if best is None or score < best[0]:
                best = (score, r)
        return best[1] if best else None

    def _scale_down(self, now: float, sig: dict):
        victim = self._pick_victim()
        if victim is None:
            return
        with _obs.span('autoscale.retire'):
            self.router.drain_replica(victim.id)
        self._draining[victim.id] = now
        self._cooldown_until = now + self.config.cooldown_s
        self._quiet_since = None
        _obs.emit('autoscale_down_begin', replica=victim.id,
                  outstanding_tokens=victim.outstanding_tokens(),
                  replicas=len(self.router.replicas),
                  ttft_p99=sig['ttft_p99'], queue_p99=sig['queue_p99'])
        if _obs.enabled():
            self._m_draining.set(len(self._draining))

    def _advance_drains(self, now: float):
        """Remove cordoned replicas whose engines have fully drained.
        Removal is the SIGTERM-graceful-drain contract: zero queued,
        zero in flight — never a dropped request."""
        if not self._draining:
            return
        for rid, t_begin in list(self._draining.items()):
            r = self.router._by_id.get(rid)
            if r is None:                     # failover already evicted it
                self._draining.pop(rid)
                continue
            if r.engine.has_work:
                continue
            with _obs.span('autoscale.retire'):
                self.router.remove_replica(rid)
                # process-backed replicas (RemoteReplica) tear their OS
                # process down through the supervisor here — SIGTERM →
                # graceful drain → reap; in-process engines have no
                # retire() and just get garbage-collected
                retire = getattr(r.engine, 'retire', None)
                if retire is not None:
                    retire()
            self._draining.pop(rid)
            _obs.emit('autoscale_down_complete', replica=rid,
                      drain_s=round(now - t_begin, 4),
                      replicas=len(self.router.replicas))
        if _obs.enabled():
            self._m_draining.set(len(self._draining))
            self._m_replicas.set(len(self.router.replicas))

    def _integrate(self, now: float):
        """Accumulate replica-seconds (hardware occupancy) — the
        denominator of 'SLO attainment per replica-hour'."""
        if self._last_integrate is not None and _obs.enabled():
            dt = max(now - self._last_integrate, 0.0)
            self._m_replica_seconds.inc(dt * len(self.router.replicas))
        self._last_integrate = now

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return {
            'enabled': self.enabled,
            'replicas': len(self.router.replicas),
            'active_replicas': self.active_replicas(),
            'draining': sorted(self._draining),
            'decisions': dict(self._decisions),
            'provision_ema_s': self._provision_ema_s,
            'cooldown_until': self._cooldown_until,
            'signal_source': ('local' if self.signal_source is None
                              else type(self.signal_source).__name__),
            'config': dataclasses.asdict(self.config),
        }
