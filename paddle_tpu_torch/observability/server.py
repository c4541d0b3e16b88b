"""HTTP observability endpoint: scrape a live server from outside (a copy
of `paddle_tpu/observability/server.py`).

A stdlib `http.server` daemon thread (no new dependencies) serving the
shared registry and event log the way every scraper expects:

  /metrics   Prometheus text (the registry, collectors included)
  /healthz   process liveness: 200 while healthy, 503 JSON while any
             degraded state is held (a draining engine: `draining`) or
             a watchdog suspects a hang
  /summary   debug.observability_summary() (?format=json for the dict)
  /events    JSONL tail of the event log (?n=200, bounded to 2000;
             ?type=a,b filters by event name, ?since=SEQ or ?since=TS.S
             resumes from a sequence number / timestamp cursor,
             ?trace_id=N keeps one request's events)
  /trace     chrome://tracing JSON of the event log
  /programs  ProgramCatalog report (?format=json for top_programs())
  /goodput   goodput-ledger report + roofline/MFU attribution
             (?format=json for the dict)
  /slo       SLO engine report: burn rates, budget remaining, breaches
             (requires `slo.set_engine`, 503 otherwise; ?poll=1 polls
             first)
  /requests  the per-request latency ledger (?top=N slowest waterfalls;
             with a fleet aggregator, its merged waterfalls under 'fleet')
  /fleet/metrics  Prometheus text of the fleet view (merged + one
             labeled section per process); requires a registered
             Aggregator (`aggregator.set_aggregator`), 503 otherwise
  /fleet/trace    skew-corrected cross-process chrome trace
             (?trace_id=N stitches one request's waterfall)

`start_server(port)` binds `0.0.0.0` by default, as the JAX server does;
port 0 binds an ephemeral port (`.port`, `.url`). Handlers only READ
shared state under the registry lock, so scrapes are safe concurrent
with the serving loop.

This module also owns the process's *liveness* state: instrumented
loops call `note_progress(kind)` per decode round (the serving engine
does), a draining engine holds `note_degraded('draining')` until
`clear_degraded`, and `note_weight_version` records the weights each
scope serves; /healthz is the external view of all three.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..analysis.runtime import concurrency as _concurrency

# -- liveness state (written by instrumented loops + the watchdog) ----------
_live_lock = _concurrency.Lock('server._live_lock')
_progress: Dict[str, float] = {}        # kind -> monotonic ts of last beat
_hangs: Dict[int, Dict[str, Any]] = {}  # watchdog id -> hang info
# (scope, state) -> {'count': refs, 'info': context}. Ref-counted, NOT
# last-writer-wins: two independent reasons to be degraded (a replica
# draining WHILE the process re-meshes, two engines draining at once)
# each hold their own reference, and /healthz stays 503 until every
# holder clears. `scope` namespaces per-entity states (the serving
# router tags each replica's engine) so a fleet router can tell WHICH
# replica is degraded; scope None is the process itself.
_degraded: Dict[Tuple[Optional[str], str], Dict[str, Any]] = {}
# scope -> live weight version (None scope = the process/trainer view);
# serving engines report through note_weight_version on every hot swap
# so /healthz answers "which weights is this replica serving" without
# touching the engine
_weight_versions: Dict[Optional[str], int] = {}
_START = time.monotonic()


def note_progress(kind: str = 'step'):
    """Heartbeat: an instrumented loop completed one unit of `kind`
    ('step', 'decode', ...). Cheap enough to call every step."""
    with _live_lock:
        _progress[kind] = time.monotonic()


def note_hang(key: int, info: Optional[Dict[str, Any]] = None):
    """A watchdog suspects the step under `key` is hung; /healthz goes
    non-200 until `clear_hang(key)` (the step finally returning)."""
    with _live_lock:
        _hangs[key] = dict(info or {})


def clear_hang(key: int):
    with _live_lock:
        _hangs.pop(key, None)


def hang_suspected() -> bool:
    return bool(_hangs)


def note_degraded(state: str, info: Optional[Dict[str, Any]] = None,
                  scope: Optional[str] = None):
    """The process entered a degraded-but-alive phase — re-meshing after
    a topology change ('resizing'), draining before a preemption exit
    ('draining'). /healthz reports the state at 503 (so routers stop
    sending traffic / schedulers know not to kill a transitioning
    process) until every `note_degraded` is matched by a
    `clear_degraded`: each call takes one reference, so concurrent
    holders of the same state (two draining engines) keep the 503 up
    until BOTH clear. `scope` namespaces the state per entity (the
    serving router scopes each replica's engine as 'replica:N')."""
    with _live_lock:
        entry = _degraded.get((scope, state))
        if entry is None:
            entry = _degraded[(scope, state)] = {'count': 0, 'info': {}}
        entry['count'] += 1
        if info:
            entry['info'] = dict(info)


def clear_degraded(state: str, scope: Optional[str] = None,
                   force: bool = False):
    """Drop one reference on `state` (the pair to a `note_degraded`);
    the state leaves /healthz when the last holder clears. `force`
    removes it outright regardless of holders (test teardown)."""
    with _live_lock:
        entry = _degraded.get((scope, state))
        if entry is None:
            return
        entry['count'] -= 1
        if force or entry['count'] <= 0:
            del _degraded[(scope, state)]


def note_weight_version(version: int, scope: Optional[str] = None):
    """Record the weight version `scope` (a replica's engine, or the
    process itself when None) is currently serving/training; shows up
    in the /healthz payload as `weight_versions` so a mixed-version
    fleet is observable from the outside during a rolling swap."""
    with _live_lock:
        _weight_versions[scope] = int(version)


def weight_versions() -> Dict[str, int]:
    """Live weight versions by scope ('process' for the scope-None
    entry) — the /healthz `weight_versions` payload."""
    with _live_lock:
        return {(sc if sc is not None else 'process'): v
                for sc, v in sorted(_weight_versions.items(),
                                    key=lambda kv: kv[0] or '')}


def degraded_states(scope: Optional[str] = '*') -> Dict[str, Dict[str, Any]]:
    """Active degraded states: `scope='*'` merges every scope, `None`
    returns only process-global states, any other string returns that
    scope's states."""
    with _live_lock:
        out: Dict[str, Dict[str, Any]] = {}
        for (sc, state), entry in _degraded.items():
            if scope == '*' or sc == scope:
                out[state] = dict(entry['info'])
        return out


def health() -> Dict[str, Any]:
    """The /healthz body: liveness + watchdog state + degraded phases +
    seconds since the last step/decode heartbeat. `states` lists EVERY
    active degraded state (+hang) — a process that is simultaneously
    draining and hang-suspected shows both, and stays 503 until both
    clear."""
    import os
    now = time.monotonic()
    with _live_lock:
        since = {k: round(now - t, 3) for k, t in _progress.items()}
        hangs = [dict(v) for v in _hangs.values()]
        degraded = {}
        names = set()
        for (scope, state), entry in sorted(
                _degraded.items(), key=lambda kv: (kv[0][0] or '',
                                                   kv[0][1])):
            key = state if scope is None else f'{scope}/{state}'
            degraded[key] = dict(entry['info'])
            degraded[key]['count'] = entry['count']
            if scope is not None:
                degraded[key]['scope'] = scope
            names.add(state)
    if hangs:
        names.add('hang_suspected')
    states = sorted(names)
    status = ('hang_suspected' if hangs
              else '+'.join(states) if states else 'ok')
    return {
        'status': status,
        'pid': os.getpid(),
        'uptime_s': round(now - _START, 3),
        'seconds_since_progress': since,
        'hangs': hangs,
        'states': states,
        'degraded': degraded,
        'weight_versions': weight_versions(),
    }


# -- the endpoint ------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    # one handler instance per request (ThreadingHTTPServer)
    protocol_version = 'HTTP/1.1'

    def log_message(self, fmt, *args):   # scrapes must not spam stdout
        pass

    def _send(self, body: str, content_type: str = 'text/plain',
              status: int = 200):
        data = body.encode('utf-8')
        self.send_response(status)
        self.send_header('Content-Type', f'{content_type}; charset=utf-8')
        self.send_header('Content-Length', str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _query(self) -> Dict[str, str]:
        return {k: v[-1] for k, v in
                parse_qs(urlparse(self.path).query).items()}

    def do_GET(self):
        route = urlparse(self.path).path.rstrip('/') or '/'
        try:
            handler = {
                '/': self._index, '/metrics': self._metrics,
                '/healthz': self._healthz, '/summary': self._summary,
                '/events': self._events, '/trace': self._trace,
                '/programs': self._programs, '/goodput': self._goodput,
                '/fleet/metrics': self._fleet_metrics,
                '/fleet/trace': self._fleet_trace, '/slo': self._slo,
                '/requests': self._requests,
            }.get(route)
            if handler is None:
                self._send(f'unknown route {route}\n', status=404)
            else:
                handler()
        except BrokenPipeError:
            pass   # scraper went away mid-response
        except Exception as exc:   # a broken section must not kill scraping
            self._send(f'{type(exc).__name__}: {exc}\n', status=500)

    def _index(self):
        self._send('paddle_tpu_torch observability: /metrics /healthz '
                   '/summary /events /trace /programs /goodput '
                   '/fleet/metrics /fleet/trace /slo /requests\n')

    def _metrics(self):
        from .exporters import to_prometheus_text
        self._send(to_prometheus_text(),
                   content_type='text/plain; version=0.0.4')

    def _healthz(self):
        body = health()
        self._send(json.dumps(body, indent=1) + '\n',
                   content_type='application/json',
                   status=200 if body['status'] == 'ok' else 503)

    def _summary(self):
        from .. import debug
        if self._query().get('format') == 'json':
            self._send(json.dumps(debug.observability_summary(as_dict=True))
                       + '\n', content_type='application/json')
        else:
            self._send(debug.observability_summary() + '\n')

    # /events responses are bounded no matter what the client asks for:
    # a scraper passing n=10**9 (or a since= cursor matching the whole
    # ring) still gets at most this many lines
    EVENTS_MAX = 2000

    def _events(self):
        from .events import get_event_log
        q = self._query()
        try:
            n = int(q.get('n', 200))
        except ValueError:
            n = 200
        n = min(max(n, 0), self.EVENTS_MAX)
        events = get_event_log().events()
        since = q.get('since')
        if since:
            try:
                if '.' in since:
                    ts = float(since)   # timestamp on the span clock
                    events = [e for e in events if e.get('ts', 0.0) >= ts]
                else:
                    seq = int(since)    # sequence-number cursor
                    events = [e for e in events if e.get('seq', 0) > seq]
            except ValueError:
                self._send(f'bad since= cursor {since!r} '
                           f'(want SEQ or TS.S)\n', status=400)
                return
        types = q.get('type')
        if types:
            wanted = set(t for t in types.split(',') if t)
            events = [e for e in events if e.get('name') in wanted]
        trace_id = q.get('trace_id')
        if trace_id is not None:
            try:
                trace_id = int(trace_id)
            except ValueError:
                pass   # string trace ids pass through as-is
            # one request's events — the /requests drill-down (the same
            # request_id attr convention /fleet/trace stitches on)
            events = [e for e in events
                      if (e.get('attrs') or {}).get('request_id')
                      == trace_id]
        self._send(''.join(json.dumps(e) + '\n' for e in events[-n:]),
                   content_type='application/jsonl')

    def _trace(self):
        from .exporters import to_chrome_trace
        self._send(json.dumps(to_chrome_trace()),
                   content_type='application/json')

    def _programs(self):
        from .cost import get_catalog
        cat = get_catalog()
        if self._query().get('format') == 'json':
            self._send(json.dumps({'programs': cat.top_programs(n=50)})
                       + '\n', content_type='application/json')
        else:
            self._send(cat.report() + '\n')

    def _fleet_metrics(self):
        from .aggregator import get_aggregator
        from .exporters import fleet_to_prometheus_text
        agg = get_aggregator()
        if agg is None:
            self._send('no fleet aggregator registered (see '
                       'observability.aggregator.set_aggregator)\n',
                       status=503)
            return
        agg.poll()
        self._send(fleet_to_prometheus_text(agg),
                   content_type='text/plain; version=0.0.4')

    def _fleet_trace(self):
        from .aggregator import get_aggregator
        agg = get_aggregator()
        if agg is None:
            self._send('no fleet aggregator registered (see '
                       'observability.aggregator.set_aggregator)\n',
                       status=503)
            return
        agg.poll()
        trace_id = self._query().get('trace_id')
        if trace_id is not None:
            try:
                trace_id = int(trace_id)
            except ValueError:
                pass   # string trace ids pass through as-is
        self._send(json.dumps(agg.stitch_trace(trace_id=trace_id)),
                   content_type='application/json')

    def _slo(self):
        from .slo import get_engine
        engine = get_engine()
        if engine is None:
            self._send('no SLO engine registered (see '
                       'observability.slo.set_engine)\n', status=503)
            return
        if self._query().get('poll') == '1':
            engine.poll()
        self._send(json.dumps(engine.report(), indent=1, default=str)
                   + '\n', content_type='application/json')

    def _goodput(self):
        from .cost import roofline_summary
        from .goodput import get_ledger
        ledger = get_ledger()
        if self._query().get('format') == 'json':
            self._send(json.dumps({'goodput': ledger.report(),
                                   'roofline': roofline_summary()})
                       + '\n', content_type='application/json')
        else:
            self._send(ledger.report_text() + '\n')

    def _requests(self):
        """The per-request latency ledger: ?top=N caps the slowest-K
        waterfalls returned (default all retained); the payload carries
        the per-phase p50/p99 decomposition and the p99-driver ranking
        — 'where did my p99 go' as data. When a fleet aggregator is
        registered, its merged cross-process waterfalls ride along
        under 'fleet'."""
        from .reqledger import get_ledger
        q = self._query()
        top = None
        if q.get('top'):
            try:
                top = max(int(q['top']), 0)
            except ValueError:
                self._send(f'bad top= {q["top"]!r} (want an int)\n',
                           status=400)
                return
        body = get_ledger().report(top=top)
        from .aggregator import get_aggregator
        agg = get_aggregator()
        if agg is not None:
            agg.poll()
            fleet = agg.requests()
            body['fleet'] = fleet[-(top or len(fleet) or 1):]
        self._send(json.dumps(body, indent=1, default=str) + '\n',
                   content_type='application/json')


class ObservabilityServer:
    """A bound, running endpoint; `stop()` to shut down (daemon threads
    die with the process otherwise — safe for long trainers)."""

    def __init__(self, port: int = 0, host: str = '0.0.0.0'):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f'paddle-obs-server:{self.port}', daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        host = '127.0.0.1' if self.host == '0.0.0.0' else self.host
        return f'http://{host}:{self.port}'

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2.0)

    def __repr__(self):
        return f'ObservabilityServer(url={self.url!r})'


_servers = []


def start_server(port: int = 0, host: str = '0.0.0.0'
                 ) -> ObservabilityServer:
    """Start the observability endpoint on a daemon thread; returns the
    running server (`.port` carries the bound port when port=0)."""
    srv = ObservabilityServer(port=port, host=host)
    _servers.append(srv)
    return srv
