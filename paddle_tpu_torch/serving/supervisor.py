"""Replica process supervisor: spawn, heartbeat, heal, quarantine (a copy
of `paddle_tpu/serving/supervisor.py`).

`remote.py` gives the Router a process-shaped replica; this module keeps
those processes alive. One `Supervisor` owns a set of children running
`replica_main`, each described by one shared `ReplicaSpec` (the same
model factory, device, WeightStore and spool: a fleet is N copies of
one recipe, differing only in name, socket and uid).

Failure policy:

- exit-code classification: 0 is a clean exit; anything else (a
  death-by-signal negative rc included) a crash; a live process whose
  healthz stops answering past the heartbeat deadline a hang, which is
  escalated to SIGKILL (a wedged child holding its socket, and on the
  card its device memory, is worse than a dead one).
- restart with exponential backoff and jitter from a seeded
  `random.Random`, so the spacing equals the JAX package's and the
  fault tests can check it from event timestamps.
- crash-loop circuit breaking: more than `max_restarts` crashes inside
  `restart_window_s` quarantines the replica (`replica_quarantined`,
  pidfile and socket swept, no further respawns).
- orphan reaping: on boot and before every spawn, stale pidfiles from a
  previous supervisor are checked against /proc; a live orphan whose
  command line really is this package's `replica_main` is SIGKILLed,
  and its socket, pidfile and spool remnants are swept.

Children are started with `subprocess` (a fresh interpreter, never a
fork), so no CUDA context is ever forked. The Autoscaler plugs in
unchanged: `supervisor.replica_factory()` is its `replica_factory`
(scale-up spawns a real process), and scale-down's `remove_replica` is
followed by `RemoteReplica.retire()`, which lands here as SIGTERM →
drain → reap. Every transition emits a declared event, which the
spool/aggregator plane makes fleet-visible.

All timing flows through an injectable `clock` and all process control
through injectable `popen_fn`/`connect_fn`, so the state-machine fault
tests run on synthetic children with no real spawn.
"""
from __future__ import annotations

import json
import os
import random
import shutil
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from .. import observability as _obs
from ..analysis.runtime import concurrency as _concurrency

_ENTRY = 'paddle_tpu_torch.serving.replica_main'
# the directory holding the package: a child interpreter imports it from
# there whatever its working directory
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# child lifecycle states
SPAWNING = 'spawning'
READY = 'ready'
BACKOFF = 'backoff'
QUARANTINED = 'quarantined'
RETIRING = 'retiring'
STOPPED = 'stopped'


@dataclass
class ReplicaSpec:
    """One recipe for a replica process (shared across the fleet). The
    JAX spec's `program_store_dir` has no counterpart (a child captures
    its graphs at boot); `device` is the child's (`cuda` unless the
    caller asks for the CPU)."""
    model_spec: str
    model_kwargs: Dict[str, Any] = field(default_factory=dict)
    engine_kwargs: Dict[str, Any] = field(default_factory=dict)
    weight_store_dir: Optional[str] = None
    weight_version: Optional[int] = None
    spool_dir: Optional[str] = None
    drain_deadline_s: float = 30.0
    env: Dict[str, str] = field(default_factory=dict)
    device: str = 'cuda'

    def argv(self, python: str, socket_path: str, uid: str,
             obs_scope: Optional[str] = None) -> List[str]:
        cmd = [python, '-m', _ENTRY,
               '--socket', socket_path,
               '--model-spec', self.model_spec,
               '--model-kwargs', json.dumps(self.model_kwargs),
               '--engine-kwargs', json.dumps(self.engine_kwargs),
               '--device', self.device,
               '--uid', uid,
               '--drain-deadline-s', str(self.drain_deadline_s)]
        if self.weight_store_dir:
            cmd += ['--weight-store', self.weight_store_dir]
        if self.weight_version is not None:
            cmd += ['--weight-version', str(self.weight_version)]
        if self.spool_dir:
            cmd += ['--spool', self.spool_dir]
        if obs_scope:
            cmd += ['--obs-scope', obs_scope]
        return cmd


class _Child:
    """Supervisor-side record of one replica process."""

    __slots__ = ('name', 'proc', 'socket_path', 'uid', 'replica', 'state',
                 'attempts', 'crash_times', 'not_before', 'ready_since',
                 'last_hb_ok', 'hb_due', 'exit_reason')

    def __init__(self, name: str, socket_path: str, uid: str):
        self.name = name
        self.socket_path = socket_path
        self.uid = uid
        self.proc = None
        self.replica = None
        self.state = SPAWNING
        self.attempts = 0            # consecutive restarts
        self.crash_times: List[float] = []   # window for the breaker
        self.not_before = 0.0        # backoff gate for the next respawn
        self.ready_since = 0.0
        self.last_hb_ok = 0.0
        self.hb_due = 0.0
        self.exit_reason = None


class Supervisor:
    """Spawn/monitor/heal a fleet of replica_main processes."""

    def __init__(self, run_dir: str, spec: ReplicaSpec, *,
                 heartbeat_interval_s: float = 1.0,
                 heartbeat_timeout_s: float = 5.0,
                 spawn_timeout_s: float = 180.0,
                 backoff_base_s: float = 0.5,
                 backoff_mult: float = 2.0,
                 backoff_cap_s: float = 30.0,
                 backoff_jitter: float = 0.25,
                 max_restarts: int = 3,
                 restart_window_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 popen_fn=None, connect_fn=None,
                 on_restart: Optional[Callable] = None,
                 python: str = sys.executable):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.spec = spec
        self.heartbeat_interval_s = heartbeat_interval_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.spawn_timeout_s = spawn_timeout_s
        self.backoff_base_s = backoff_base_s
        self.backoff_mult = backoff_mult
        self.backoff_cap_s = backoff_cap_s
        self.backoff_jitter = backoff_jitter
        self.max_restarts = max_restarts
        self.restart_window_s = restart_window_s
        self.clock = clock
        self.sleep = sleep
        self.popen_fn = popen_fn or self._default_popen
        self.connect_fn = connect_fn or self._default_connect
        self.on_restart = on_restart
        self.python = python
        self._lock = _concurrency.RLock('Supervisor._lock')
        self._children: Dict[str, _Child] = {}
        self._seq = 0
        # deterministic jitter: reproducible spacing for the fault tests
        self._rng = random.Random(0x5EED)
        self._m_replicas = _obs.get_registry().gauge(
            'paddle_supervisor_replicas',
            'supervised replica processes by state', ('state',))
        self.reap_orphans()

    # -- metrics helpers ---------------------------------------------------
    def _count(self, name: str, help_: str, **labels):
        if _obs.enabled():
            reg = _obs.get_registry()
            reg.counter(name, help_, tuple(labels)).labels(**labels).inc() \
                if labels else reg.counter(name, help_).inc()

    def _refresh_gauge(self):
        if not _obs.enabled():
            return
        counts: Dict[str, int] = {}
        for c in self._children.values():
            counts[c.state] = counts.get(c.state, 0) + 1
        for state in (SPAWNING, READY, BACKOFF, QUARANTINED, RETIRING,
                      STOPPED):
            self._m_replicas.labels(state=state).set(counts.get(state, 0))

    # -- default process plumbing -----------------------------------------
    def _default_popen(self, argv: List[str], env: Dict[str, str],
                       log_path: str):
        log = open(log_path, 'ab')
        try:
            return subprocess.Popen(argv, env=env, stdout=log, stderr=log,
                                    start_new_session=True)
        finally:
            log.close()   # the child holds its own fd now

    def _default_connect(self, child: _Child):
        """Poll-connect until the child binds its socket (readiness =
        warm and serviceable) or the spawn deadline passes."""
        from .remote import RemoteReplica
        deadline = self.clock() + self.spawn_timeout_s
        last: Optional[BaseException] = None
        while self.clock() < deadline:
            rc = child.proc.poll()
            if rc is not None:
                raise RuntimeError(
                    f'replica {child.name} exited rc={rc} during spawn '
                    f'(see {self._log_path(child.name)})')
            rr = RemoteReplica(child.socket_path, name=child.name,
                              supervisor=self)
            try:
                rr.connect(deadline_s=2.0)
                return rr
            except (ConnectionError, OSError, TimeoutError) as exc:
                last = exc
                rr.close()
                self.sleep(0.1)
        raise TimeoutError(
            f'replica {child.name} not connectable within '
            f'{self.spawn_timeout_s}s') from last

    # -- paths -------------------------------------------------------------
    def _socket_path(self, name: str) -> str:
        return os.path.join(self.run_dir, f'{name}.sock')

    def _pidfile_path(self, name: str) -> str:
        return os.path.join(self.run_dir, f'{name}.json')

    def _log_path(self, name: str) -> str:
        return os.path.join(self.run_dir, f'{name}.log')

    # -- orphan / stale-state sweep ---------------------------------------
    def reap_orphans(self) -> int:
        """Sweep pidfiles/sockets left by a previous supervisor
        incarnation. A pidfile's process is killed ONLY when /proc
        confirms it still is this package's replica_main (pids recycle;
        a recycled
        pid must never catch a stray SIGKILL). Returns processes
        killed."""
        killed = 0
        with self._lock:
            owned = {c.name for c in self._children.values()}
            for fname in sorted(os.listdir(self.run_dir)):
                base, ext = os.path.splitext(fname)
                if ext not in ('.json', '.sock') or base in owned:
                    continue
                path = os.path.join(self.run_dir, fname)
                if ext == '.json':
                    pid, uid = None, None
                    try:
                        with open(path) as f:
                            rec = json.load(f)
                        pid, uid = rec.get('pid'), rec.get('uid')
                    except (OSError, ValueError):
                        _obs.count_suppressed('supervisor_pidfile')
                    if pid is not None and self._is_replica_proc(pid):
                        try:
                            os.kill(int(pid), signal.SIGKILL)
                            killed += 1
                            _obs.emit('replica_orphan_reaped',
                                      pid=int(pid), pidfile=fname)
                            self._count(
                                'paddle_supervisor_orphans_reaped_total',
                                'orphaned replica processes SIGKILLed '
                                'at supervisor boot')
                        except OSError:
                            _obs.count_suppressed('supervisor_orphan_kill')
                    if uid and self.spec.spool_dir:
                        stale_spool = os.path.join(self.spec.spool_dir,
                                                   str(uid))
                        if os.path.isdir(stale_spool):
                            shutil.rmtree(stale_spool, ignore_errors=True)
                try:
                    os.unlink(path)
                    self._count(
                        'paddle_supervisor_stale_cleaned_total',
                        'stale pidfiles/sockets swept by the supervisor')
                except OSError:
                    _obs.count_suppressed('supervisor_stale_unlink')
        return killed

    @staticmethod
    def _is_replica_proc(pid) -> bool:
        try:
            with open(f'/proc/{int(pid)}/cmdline', 'rb') as f:
                return _ENTRY.encode() in f.read()
        except (OSError, ValueError):
            return False

    # -- spawn / respawn ---------------------------------------------------
    def spawn(self, name: Optional[str] = None):
        """Start one replica process and block until it answers hello
        (warm-started and serviceable). Returns its RemoteReplica —
        exactly what `Router.add_replica` / the Autoscaler's
        replica_factory expect."""
        with self._lock:
            if name is None:
                name = f'r{self._seq}'
            self._seq += 1
            if name in self._children and \
                    self._children[name].state not in (STOPPED,):
                raise ValueError(f'replica {name!r} already supervised')
            self.reap_orphans()
            child = _Child(name, self._socket_path(name),
                           uid=f'{name}-{self._seq}')
            self._children[name] = child
        return self._start(child)

    def _start(self, child: _Child):
        now = self.clock()
        child.state = SPAWNING
        argv = self.spec.argv(self.python, child.socket_path, child.uid,
                              obs_scope=f'proc:{child.name}')
        env = dict(os.environ)
        env['PYTHONPATH'] = os.pathsep.join(
            p for p in (_ROOT, env.get('PYTHONPATH')) if p)
        env.update(self.spec.env)
        _obs.emit('replica_spawn', replica=child.name, attempt=child.attempts)
        self._count('paddle_supervisor_spawns_total',
                    'replica processes launched')
        child.proc = self.popen_fn(argv, env, self._log_path(child.name))
        with open(self._pidfile_path(child.name), 'w') as f:
            json.dump({'pid': child.proc.pid, 'name': child.name,
                       'socket': child.socket_path, 'uid': child.uid}, f)
        try:
            child.replica = self.connect_fn(child)
        except BaseException:
            # a child that never became ready counts as a crash: kill
            # whatever half-started, record it, re-raise to the caller
            self._kill_proc(child)
            self._cleanup_files(child)
            child.state = STOPPED
            self._refresh_gauge()
            raise
        child.state = READY
        child.ready_since = now
        child.last_hb_ok = self.clock()
        child.hb_due = child.last_hb_ok + self.heartbeat_interval_s
        _obs.emit('replica_ready', replica=child.name,
                  pid=child.proc.pid, attempt=child.attempts)
        self._refresh_gauge()
        return child.replica

    # -- teardown helpers --------------------------------------------------
    def _kill_proc(self, child: _Child):
        if child.proc is not None and child.proc.poll() is None:
            try:
                child.proc.kill()
                child.proc.wait()
            except OSError:
                _obs.count_suppressed('supervisor_kill')

    def _cleanup_files(self, child: _Child):
        for path in (self._pidfile_path(child.name), child.socket_path):
            try:
                if os.path.exists(path):
                    os.unlink(path)
            except OSError:
                _obs.count_suppressed('supervisor_cleanup')
        if child.replica is not None:
            child.replica.close()

    # -- the state machine -------------------------------------------------
    def poll(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One monitoring pass: reap exits, heartbeat the living,
        respawn the backed-off, quarantine the flapping. Drive this from
        any loop (the fleet tests call it directly with a fake clock)."""
        if now is None:
            now = self.clock()
        with self._lock:
            for child in list(self._children.values()):
                if child.state == READY:
                    self._poll_ready(child, now)
                elif child.state == BACKOFF:
                    self._poll_backoff(child, now)
            self._refresh_gauge()
            return self.stats()

    def _poll_ready(self, child: _Child, now: float):
        rc = child.proc.poll()
        if rc is not None:
            reason = 'clean_exit' if rc == 0 else 'crash'
            _obs.emit('replica_exit', replica=child.name, rc=rc,
                      reason=reason)
            self._on_death(child, now, reason=reason, rc=rc)
            return
        # a stretch of sustained health forgives past crashes: the
        # consecutive-attempt counter (backoff exponent) resets
        if child.attempts and \
                now - child.ready_since > self.restart_window_s:
            child.attempts = 0
        if now >= child.hb_due:
            child.hb_due = now + self.heartbeat_interval_s
            try:
                child.replica.healthz(
                    deadline_s=self.heartbeat_timeout_s)
                child.last_hb_ok = now
            except (ConnectionError, OSError, TimeoutError):
                self._count('paddle_supervisor_heartbeat_misses_total',
                            'replica heartbeat probes that failed')
                if now - child.last_hb_ok >= self.heartbeat_timeout_s:
                    # live pid, dead socket: wedged. Escalate to SIGKILL
                    # and restart — hang is the third exit class.
                    _obs.emit('replica_hang', replica=child.name,
                              pid=child.proc.pid,
                              silent_s=round(now - child.last_hb_ok, 3))
                    self._kill_proc(child)
                    self._on_death(child, now, reason='hang',
                                   rc=child.proc.poll())

    def _on_death(self, child: _Child, now: float, *, reason: str, rc):
        self._cleanup_files(child)
        child.replica = None
        if child.state == RETIRING:
            child.state = STOPPED
            _obs.emit('replica_retired', replica=child.name, rc=rc)
            return
        if reason != 'clean_exit':
            _obs.emit('replica_crash', replica=child.name, rc=rc,
                      reason=reason)
        child.attempts += 1
        child.crash_times.append(now)
        child.crash_times = [t for t in child.crash_times
                             if now - t <= self.restart_window_s]
        if len(child.crash_times) > self.max_restarts:
            child.state = QUARANTINED
            child.exit_reason = reason
            _obs.emit('replica_quarantined', replica=child.name,
                      crashes_in_window=len(child.crash_times),
                      window_s=self.restart_window_s, reason=reason)
            self._count('paddle_supervisor_quarantined_total',
                        'replicas circuit-broken out of the respawn loop')
            return
        backoff = self._backoff_s(child.attempts)
        child.state = BACKOFF
        child.not_before = now + backoff
        _obs.emit('replica_restart', replica=child.name,
                  attempt=child.attempts, backoff_s=round(backoff, 3),
                  reason=reason)
        self._count('paddle_supervisor_restarts_total',
                    'replica respawns scheduled', reason=reason)

    def _poll_backoff(self, child: _Child, now: float):
        if now < child.not_before:
            return
        try:
            replica = self._start(child)
        except BaseException:
            # a failed respawn is one more crash against the window
            _obs.count_suppressed('supervisor_respawn')
            self._on_death(child, self.clock(), reason='crash', rc=None)
            return
        if self.on_restart is not None:
            self.on_restart(child.name, replica)

    def _backoff_s(self, attempt: int) -> float:
        base = self.backoff_base_s * (
            self.backoff_mult ** max(0, attempt - 1))
        base = min(base, self.backoff_cap_s)
        return base * (1.0 + self._rng.uniform(-self.backoff_jitter,
                                               self.backoff_jitter))

    # -- explicit control --------------------------------------------------
    def retire(self, name: str, deadline_s: float = 30.0):
        """Graceful teardown: SIGTERM (the child drains under its own
        deadline and exits 0), bounded wait, SIGKILL past the bound.
        The scale-down path: Autoscaler -> remove_replica ->
        RemoteReplica.retire -> here."""
        with self._lock:
            child = self._children.get(name)
            if child is None or child.proc is None:
                return
            child.state = RETIRING
            try:
                child.proc.send_signal(signal.SIGTERM)
            except OSError:
                _obs.count_suppressed('supervisor_sigterm')
        try:
            child.proc.wait(timeout=deadline_s)
        except Exception:
            # drain deadline blown (or a fake proc without timeouts):
            # escalate to SIGKILL — retire must always converge
            _obs.count_suppressed('supervisor_retire_wait')
            self._kill_proc(child)
        with self._lock:
            self._on_death(child, self.clock(), reason='retired',
                           rc=child.proc.poll())
            self._refresh_gauge()

    def kill(self, name: str):
        """SIGKILL a child (chaos injection / hang escalation). The next
        poll() classifies the death and schedules the respawn."""
        with self._lock:
            child = self._children.get(name)
        if child is not None and child.proc is not None:
            try:
                child.proc.send_signal(signal.SIGKILL)
            except OSError:
                _obs.count_suppressed('supervisor_sigkill')

    def stop_all(self, deadline_s: float = 10.0):
        for name, child in list(self._children.items()):
            if child.state in (READY, SPAWNING, BACKOFF):
                self.retire(name, deadline_s=deadline_s)
        self._refresh_gauge()

    # -- integration -------------------------------------------------------
    def replica_factory(self) -> Callable[[], Any]:
        """Zero-arg factory for `Autoscaler(replica_factory=...)`: each
        call provisions a fresh supervised PROCESS and returns its
        RemoteReplica (already warm: spawn blocks on readiness)."""
        return lambda: self.spawn()

    def replicas(self) -> Dict[str, Any]:
        with self._lock:
            return {name: c.replica for name, c in self._children.items()
                    if c.state == READY}

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name, c in self._children.items():
            out[name] = {
                'state': c.state,
                'pid': c.proc.pid if c.proc is not None else None,
                'attempts': c.attempts,
                'crashes_in_window': len(c.crash_times),
                'uid': c.uid,
            }
        return out
