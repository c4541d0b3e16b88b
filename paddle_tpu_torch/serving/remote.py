"""Cross-process replica RPC: checksummed JSON frames + RemoteReplica (a
copy of `paddle_tpu/serving/remote.py`: the same frames, byte for byte).

In one process the router, the trainer and every `InferenceEngine`
replica share one interpreter, so a replica "crash" is an injected
exception and a swap never crosses a process boundary. This module is
the client half of the process fleet; `replica_main.py` is the process
entry point and `supervisor.py` spawns and heals the children.

Wire protocol (stdlib only):

- one request or response per frame over an AF_UNIX stream socket;
- frame = 4-byte big-endian payload length, then a 64-hex-char sha256
  digest, then the UTF-8 JSON payload (one JSON doc per frame);
- a short read raises `IncompleteFrameError` (a ConnectionError: the
  peer died mid-frame) and a digest mismatch raises
  `FrameChecksumError`; both are transient through `resilience.retry`,
  so the Router's failover treats a torn frame like a lost replica:
  evict and resubmit to survivors, never trust a half-message;
- every call carries a per-call deadline via socket timeouts
  (`socket.timeout` is a TimeoutError, transient by type).

`RemoteReplica` implements the engine duck type the Router and the
Autoscaler already place requests against (submit/step/has_work/
evict_all/begin_drain/drain/stats/healthz/swap_weights, plus the
`scheduler.queue_depth`/`pending()` and `_slot_req` views the load
estimator reads), so routing, QoS, breakers and failover are untouched
by the process split. The client keeps a local mirror `RequestHandle`
per in-flight request, updated from each `step` response: when the
child dies mid-decode, `evict_all()` cannot ask it anything, so it
returns the local mirrors and the Router resubmits them elsewhere,
token for token for greedy and seeded requests.

No tensor crosses this socket. `swap_weights` ships only the VERSION;
the child loads that version from its own `WeightStore` handle (the
store, sha256-verified, is the weight plane; the RPC is the control
signal). A child captures its CUDA graphs before it binds its socket
(`replica_main.py`), so it serves without capturing or compiling.
"""
from __future__ import annotations

import hashlib
import json
import socket
import struct
import time
from typing import Any, Dict, List, Optional

from .. import observability as _obs
from ..observability import reqledger as _reqledger
from ..analysis.runtime import concurrency as _concurrency
from ..resilience.retry import (FatalError, TransientError,
                                register_transient)
from .api import FAILED, FINISHED, QUEUED, RUNNING, RequestHandle, \
    SamplingParams
from .engine import InferenceEngine

_LEN = struct.Struct('>I')
_DIGEST_LEN = 64
FRAME_MAX = 64 * 1024 * 1024   # a frame past this is corruption, not data


class RpcError(RuntimeError):
    """Base for RPC-layer failures that are not connection losses."""


class IncompleteFrameError(ConnectionError):
    """Peer closed (or the kernel gave up) mid-frame: a length prefix or
    payload arrived short. ConnectionError subclass → transient by type."""


class FrameChecksumError(ConnectionError):
    """Frame arrived complete but its sha256 does not match: torn or
    corrupted stream. The connection is untrustworthy from here on, so
    this is a connection-class (transient) failure, not a protocol bug."""


class RemoteTransientError(TransientError):
    """Child-side failure the child itself classified transient."""


class RemoteFatalError(FatalError):
    """Child-side failure classified fatal (poisons the failover chain)."""


# the error vocabulary a child may rehydrate by name on the client side:
# submit()-time validation must raise the SAME types remotely as locally
# (the Router catches ValueError from engine.submit, tenancy tests rely
# on TypeError for bad kwargs)
_REHYDRATE: Dict[str, type] = {
    'ValueError': ValueError,
    'TypeError': TypeError,
    'RuntimeError': RuntimeError,
    'KeyError': KeyError,
    'TimeoutError': TimeoutError,
}

register_transient(IncompleteFrameError)
register_transient(FrameChecksumError)


def _digest(payload: bytes) -> bytes:
    return hashlib.sha256(payload).hexdigest().encode('ascii')


def send_msg(sock: socket.socket, obj: Dict[str, Any]) -> int:
    """Serialize + frame + send one message; returns bytes on the wire."""
    payload = json.dumps(obj, separators=(',', ':')).encode('utf-8')
    frame = _LEN.pack(len(payload)) + _digest(payload) + payload
    sock.sendall(frame)
    return len(frame)


def _recv_exact(sock: socket.socket, n: int, what: str) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise IncompleteFrameError(
                f'incomplete frame: peer closed after {len(buf)}/{n} '
                f'bytes of {what}')
        buf += chunk
    return bytes(buf)


def recv_msg(sock: socket.socket) -> Dict[str, Any]:
    """Receive one framed message; verifies length and sha256 before any
    byte of the payload is trusted (torn-frame rejection)."""
    header = _recv_exact(sock, _LEN.size, 'length prefix')
    (length,) = _LEN.unpack(header)
    if length > FRAME_MAX:
        raise FrameChecksumError(
            f'frame length {length} exceeds FRAME_MAX ({FRAME_MAX}): '
            f'corrupt length prefix')
    digest = _recv_exact(sock, _DIGEST_LEN, 'sha256 digest')
    payload = _recv_exact(sock, length, 'payload')
    if _digest(payload) != digest:
        raise FrameChecksumError(
            f'frame sha256 mismatch over {length} payload bytes')
    return json.loads(payload.decode('utf-8'))


def params_to_wire(params: SamplingParams) -> Dict[str, Any]:
    return {k: getattr(params, k) for k in SamplingParams.__slots__}


def params_from_wire(d: Dict[str, Any]) -> SamplingParams:
    return SamplingParams(**d)


def _rehydrate_error(err: Dict[str, Any]) -> BaseException:
    """Turn a child-side error descriptor back into a typed exception.
    Known builtins come back as themselves (submit validation); anything
    else becomes Remote{Transient,Fatal}Error per the CHILD's
    classification — the child ran `is_transient` over the live
    exception chain, which the wire cannot carry."""
    name = err.get('type', 'RuntimeError')
    msg = err.get('message', '')
    cls = _REHYDRATE.get(name)
    if cls is not None:
        return cls(msg)
    if err.get('transient'):
        return RemoteTransientError(f'{name}: {msg}')
    return RemoteFatalError(f'{name}: {msg}')


class RpcClient:
    """One AF_UNIX connection speaking the framed protocol, with per-call
    deadlines and call/error/bytes accounting."""

    def __init__(self, socket_path: str, *, connect_timeout_s: float = 10.0,
                 call_timeout_s: float = 30.0):
        self.socket_path = socket_path
        self.call_timeout_s = float(call_timeout_s)
        self._lock = _concurrency.RLock('RpcClient._lock')
        self._sock: Optional[socket.socket] = None
        self._connect_timeout_s = float(connect_timeout_s)

    @property
    def connected(self) -> bool:
        return self._sock is not None

    def connect(self, deadline_s: Optional[float] = None):
        with self._lock:
            if self._sock is not None:
                return
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.settimeout(deadline_s if deadline_s is not None
                            else self._connect_timeout_s)
            try:
                sock.connect(self.socket_path)
            except BaseException:
                sock.close()
                raise
            self._sock = sock

    def close(self):
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    _obs.count_suppressed('rpc_close')
                self._sock = None

    def call(self, method: str, timeout_s: Optional[float] = None,
             **args) -> Dict[str, Any]:
        """One request/response round trip. Any connection-class failure
        closes the socket (the stream is unusable mid-frame) and
        propagates — the caller's failover logic owns recovery."""
        deadline = self.call_timeout_s if timeout_s is None else timeout_s
        with self._lock:
            if self._sock is None:
                self.connect()
            sock = self._sock
            sock.settimeout(deadline)
            if _obs.enabled():
                _obs.get_registry().counter(
                    'paddle_rpc_calls_total',
                    'replica RPC round trips by method',
                    ('method',)).labels(method=method).inc()
            try:
                sent = send_msg(sock, {'method': method, 'args': args})
                resp = recv_msg(sock)
            except (ConnectionError, OSError, TimeoutError):
                if _obs.enabled():
                    _obs.get_registry().counter(
                        'paddle_rpc_errors_total',
                        'replica RPC calls lost to connection failures',
                        ('method',)).labels(method=method).inc()
                self.close()
                raise
        if 'error' in resp:
            raise _rehydrate_error(resp['error'])
        if _obs.enabled():
            _obs.get_registry().counter(
                'paddle_rpc_bytes_total',
                'replica RPC bytes by direction', ('direction',)
            ).labels(direction='sent').inc(sent)
        return resp.get('result', {})


class _MirrorScheduler:
    """The two attributes the Router's load estimator reads off
    `replica.engine.scheduler`, served from the client-side mirrors
    (zero RPCs on the placement hot path)."""

    def __init__(self, owner: 'RemoteReplica'):
        self._owner = owner

    @property
    def queue_depth(self) -> int:
        return sum(1 for h in self._owner._handles.values()
                   if h.status == QUEUED)

    def pending(self) -> List[RequestHandle]:
        return [h for h in self._owner._handles.values()
                if h.status == QUEUED]


class RemoteReplica:
    """Engine-duck-typed client for one replica process.

    Router/Autoscaler integration points served LOCALLY (no RPC):
    `has_work`, `scheduler.queue_depth`, `scheduler.pending()`,
    `_slot_req`, `weight_version`, `prefill_chunk_tokens` — all are
    read every router step, and all are derivable from the mirrors the
    last `step` response refreshed. RPCs happen only where work
    happens: submit, step, drain, evict, swap, stats, healthz.
    """

    def __init__(self, socket_path: str, *, name: Optional[str] = None,
                 connect_timeout_s: float = 10.0,
                 call_timeout_s: float = 30.0,
                 supervisor=None):
        self._rpc = RpcClient(socket_path,
                              connect_timeout_s=connect_timeout_s,
                              call_timeout_s=call_timeout_s)
        self.name = name or socket_path
        self.socket_path = socket_path
        self.supervisor = supervisor
        self._lock = _concurrency.RLock('RemoteReplica._lock')
        # remote-rid -> local mirror handle, in submission order
        self._handles: Dict[int, RequestHandle] = {}
        # fake-slot -> RUNNING mirror (Replica.outstanding_tokens reads
        # `.params.max_new_tokens` and `.tokens` off the values)
        self._slot_req: Dict[int, RequestHandle] = {}
        self.scheduler = _MirrorScheduler(self)
        self.weight_version: Optional[int] = None
        self.prefill_chunk_tokens: Optional[int] = None
        self.num_slots: Optional[int] = None
        self.max_length: Optional[int] = None
        self.pid: Optional[int] = None
        self.process_uid: Optional[str] = None
        self._obs_scope: Optional[str] = None
        self._draining = False

    # -- lifecycle ---------------------------------------------------------
    def connect(self, deadline_s: Optional[float] = None) -> Dict[str, Any]:
        """Handshake: connect and pull the engine geometry the Router's
        estimators need (slots, lengths, live weight version)."""
        self._rpc.connect(deadline_s)
        info = self._rpc.call('hello')
        with self._lock:
            self.weight_version = info.get('weight_version')
            self.prefill_chunk_tokens = info.get('prefill_chunk_tokens')
            self.num_slots = info.get('num_slots')
            self.max_length = info.get('max_length')
            self.pid = info.get('pid')
            self.process_uid = info.get('uid')
        return info

    def close(self):
        self._rpc.close()

    # -- observability scope (Replica.__init__ assigns this) ---------------
    @property
    def obs_scope(self) -> Optional[str]:
        return self._obs_scope

    @obs_scope.setter
    def obs_scope(self, scope: Optional[str]):
        self._obs_scope = scope
        # best effort: the child tags ITS engine metrics/events with the
        # same scope so stitched fleet traces attribute per replica. A
        # dead child just misses the retag until respawn re-applies it.
        try:
            self._rpc.call('set_obs_scope', scope=scope)
        except (ConnectionError, OSError, TimeoutError):
            _obs.count_suppressed('rpc_set_obs_scope')

    # -- engine surface ----------------------------------------------------
    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def has_work(self) -> bool:
        with self._lock:
            return any(not h.done for h in self._handles.values())

    def submit(self, prompt, params: Optional[SamplingParams] = None,
               priority: Optional[int] = None,
               adapter_id: Optional[str] = None, **kwargs) -> RequestHandle:
        """Mirror of `InferenceEngine.submit`: validation errors raise
        here (rehydrated by type from the child), accepted requests get
        a LOCAL handle whose stream()/result() drive `self.step()`.
        `adapter_id` ships over the wire — a bank-less child rejects it
        with the same typed ValueError an in-process engine raises (and
        the Router's step-0 availability check keeps adapter traffic
        off process replicas entirely until child banks are wired)."""
        if params is None:
            params = SamplingParams(**kwargs)
        elif kwargs:
            raise TypeError('pass params= or keyword sampling args, '
                            'not both')
        toks = InferenceEngine._normalize_prompt(prompt)
        res = self._rpc.call('submit', prompt_tokens=toks,
                             params=params_to_wire(params),
                             priority=priority, adapter_id=adapter_id)
        h = RequestHandle(toks, params, engine=self)
        if priority is not None:
            h.priority = int(priority)
        h.adapter_id = adapter_id
        if _reqledger.enabled():
            # the PARENT keeps this request's ledger record (the child's
            # engine ships its own over the wire plane; the mirror's is
            # what the Router adopts and the client sees)
            rec = _reqledger.get_ledger().open_for(h)
            if rec is not None:
                rec.queue_enter(h._t_submit, 'priority_queued')
        rid = res.get('rid')
        with self._lock:
            self._handles[int(rid)] = h
        return h

    def step(self) -> int:
        """One decode-block step in the child; applies the per-request
        mirror updates from the response. A connection failure
        propagates (transient by type) so `Router.step` runs its normal
        evict-and-resubmit failover — crash isolation, same code path."""
        t0 = time.perf_counter()
        res = self._rpc.call('step')
        t1 = time.perf_counter()
        # ledger attribution uses PRE-update mirror statuses and runs
        # BEFORE _apply_updates: the round that produces a first token
        # must land in that request's TTFT sub-book (mark_first fires
        # inside _emit during the update apply). Each RUNNING mirror's
        # timeline tiles exactly: the parent-loop gap since its last
        # touch books as decode (the request was mid-decode, waiting
        # for its replica's turn), the framing surplus as
        # rpc_transport, the child's reported step wall as decode
        # (fair-share + engine-wall books ride note_round). QUEUED
        # mirrors stay in queue_wait.
        step_wall = float(res.get('step_wall_s') or 0.0)
        rpc_surplus = max((t1 - t0) - step_wall, 0.0)
        with self._lock:
            running = [h._ledger_rec for h in self._handles.values()
                       if h.status == RUNNING]
        t_round0 = t1 - step_wall
        for rec in running:
            if rec is None:
                continue
            gap = (t0 - rec._last_touch)
            if gap > 0.0:
                rec.add('decode', gap, now=t0)
            if rpc_surplus > 0.0:
                rec.add('rpc_transport', rpc_surplus,
                        now=min(t0 + rpc_surplus, t_round0))
        _reqledger.get_ledger().note_round(step_wall, running,
                                           'decode', now=t1)
        return self._apply_updates(res)

    def _apply_updates(self, res: Dict[str, Any]) -> int:
        now = time.perf_counter()
        with self._lock:
            for rid_s, upd in res.get('updates', {}).items():
                h = self._handles.get(int(rid_s))
                if h is None:
                    continue
                status = upd.get('status')
                if (h.status == QUEUED and h._ledger_rec is not None
                        and status in (RUNNING, FINISHED, FAILED)):
                    # first round the child reported it past the queue:
                    # the mirror's queue_wait ends here — BEFORE the
                    # token emit below fires mark_first, so the final
                    # queue interval still lands in the TTFT sub-book
                    h._ledger_rec.queue_exit(now)
                toks = upd.get('tokens', [])
                for tok in toks[len(h.tokens):]:
                    h._emit(tok, now)
                if upd.get('weight_version') is not None:
                    h.weight_version = upd['weight_version']
                if upd.get('adapter_version') is not None:
                    h.adapter_version = upd['adapter_version']
                if status == RUNNING and h.status == QUEUED:
                    h.status = RUNNING
                elif status == FINISHED and not h.done:
                    h._finish(now)
                elif status == FAILED and not h.done:
                    h._fail(_rehydrate_error(upd.get('error') or {}))
            self._refresh_slots()
        return int(res.get('progressed', 0))

    def _refresh_slots(self):
        # caller holds self._lock
        self._slot_req.clear()
        slot = 0
        for h in self._handles.values():
            if h.status == RUNNING:
                self._slot_req[slot] = h
                slot += 1

    def evict_all(self) -> List[RequestHandle]:
        """Failover hand-off. ALWAYS serves from the local mirrors — the
        caller is usually standing over a corpse, and the mirrors are
        exactly what the child had accepted. When the child is still
        alive (drain-triggered evictions), a best-effort RPC clears its
        side too so slots free for the next tenant of the socket."""
        with self._lock:
            orphans = [h for h in self._handles.values() if not h.done]
            self._handles.clear()
            self._slot_req.clear()
        try:
            self._rpc.call('evict_all', timeout_s=5.0)
        except (ConnectionError, OSError, TimeoutError):
            # the dead-child case: mirrors already harvested above
            _obs.count_suppressed('rpc_evict_dead')
        return orphans

    def begin_drain(self):
        """Cordon: flip the child draining AND mirror the scoped
        `draining` degraded state into THIS process — the Router's
        health gate reads the parent-side observability server, which
        cannot see into the child."""
        self._draining = True
        with self._lock:
            info = {'queued': self.scheduler.queue_depth,
                    'in_flight': len(self._slot_req)}
        _obs.note_degraded('draining', info, scope=self._obs_scope)
        try:
            self._rpc.call('begin_drain')
        except (ConnectionError, OSError, TimeoutError):
            _obs.count_suppressed('rpc_begin_drain')

    def drain(self, deadline_s: Optional[float] = None) -> bool:
        """Drive the child's drain to completion. The RPC deadline wraps
        the child-side drain deadline with margin, so a hung child
        surfaces as a timeout here rather than a silent stall."""
        self._draining = True
        _obs.note_degraded('draining', {}, scope=self._obs_scope)
        deadline = 30.0 if deadline_s is None else float(deadline_s)
        res = self._rpc.call('drain', timeout_s=deadline + 10.0,
                             deadline_s=deadline)
        self._apply_updates(res)
        return bool(res.get('ok', False))

    def swap_weights(self, state=None, *, version: int, strict: bool = True):
        """Cross-process hot swap: ships ONLY the version number. The
        child loads that exact version from its own WeightStore handle
        (sha256-verified at read) — device arrays never serialize over
        the control socket. `state` is accepted for surface parity with
        the in-process engine and ignored: the store is authoritative."""
        res = self._rpc.call('swap_weights', timeout_s=120.0,
                             version=int(version), strict=bool(strict))
        with self._lock:
            self.weight_version = res.get('weight_version', int(version))
        return res.get('prev_version')

    def restore_weights(self, prev):
        """Rollback partner of swap_weights: `prev` is the version token
        swap_weights returned (the previous version number)."""
        if prev is None:
            raise RuntimeError('no previous weight version to restore')
        return self.swap_weights(version=int(prev))

    def healthz(self, deadline_s: float = 5.0) -> Dict[str, Any]:
        """Liveness probe: cheap by design (no engine lock in the child)
        so a heartbeat answers even mid-decode-block. SIGSTOPped or hung
        children time out here — the supervisor's hang detector."""
        return self._rpc.call('healthz', timeout_s=deadline_s)

    def stats(self) -> Dict[str, Any]:
        res = self._rpc.call('stats')
        res['remote'] = {'socket': self.socket_path, 'pid': self.pid,
                         'uid': self.process_uid}
        return res

    def generate_many(self, prompts, params=None,
                      adapter_ids=None) -> List[RequestHandle]:
        """Submit a batch and step the child until every request is
        done. `params` and `adapter_ids` are one for all or one per
        prompt, as the port engine's `generate_many` takes them."""
        if params is None or isinstance(params, SamplingParams):
            params = [params] * len(prompts)
        if adapter_ids is None or isinstance(adapter_ids, str):
            adapter_ids = [adapter_ids] * len(prompts)
        if not len(params) == len(adapter_ids) == len(prompts):
            raise ValueError('one SamplingParams and one adapter id (or '
                             'None) per prompt')
        handles = [self.submit(p, params=sp, adapter_id=aid)
                   for p, sp, aid in zip(prompts, params, adapter_ids)]
        while any(not h.done for h in handles):
            self.step()
        return handles

    def retire(self, deadline_s: float = 30.0):
        """Tear the PROCESS down: through the supervisor when one owns
        this replica (SIGTERM → graceful drain → reap → pidfile/socket
        cleanup), else a direct shutdown RPC. The Autoscaler calls this
        after `remove_replica` so scale-down retires real processes."""
        if self.supervisor is not None:
            self.supervisor.retire(self.name, deadline_s=deadline_s)
            return
        try:
            self._rpc.call('shutdown', timeout_s=deadline_s)
        except (ConnectionError, OSError, TimeoutError):
            _obs.count_suppressed('rpc_shutdown')
        self.close()

    def __repr__(self):
        return (f'RemoteReplica(name={self.name!r}, pid={self.pid}, '
                f'socket={self.socket_path!r})')
