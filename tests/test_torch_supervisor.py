"""The replica supervisor (paddle_tpu_torch.serving.supervisor) against
the JAX package's, on synthetic children: no real spawn.

The `FakeProc` / `FakeReplica` harness of the JAX package's fault tests
drives both `Supervisor`s through the same fault scripts on one
hand-cranked clock: clean exits, crashes (rc and signal), a hang
escalated to SIGKILL, exponential backoff with its seeded jitter, the
forgiveness of attempts after sustained health, the crash-loop
quarantine, slow crashes that never quarantine, a retire, a child that
never becomes ready and respawns that keep failing. Each script's
transcript (every supervisor event with its clock time and attributes,
pids numbered by first appearance, the spawn times and each child's
final state) must be equal between the packages: event names, backoff
spacing and quarantine alike. Orphan reaping runs on real sleeping
processes: the port reaps a live orphan whose command line is the
port's `replica_main`, and spares a recycled pid.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest

from paddle_tpu import observability as jobs
from paddle_tpu.serving import supervisor as jsup
from paddle_tpu_torch import observability as pobs
from paddle_tpu_torch.serving import supervisor as psup
from test_torch_observability import isolated_observability

PKG = {'jax': (jobs, jsup), 'torch': (pobs, psup)}
_SUPERVISOR_EVENTS = ('replica_spawn', 'replica_ready', 'replica_exit',
                      'replica_crash', 'replica_hang', 'replica_restart',
                      'replica_quarantined', 'replica_retired')


@pytest.fixture(autouse=True, scope='module')
def _isolated(tmp_path_factory):
    yield from isolated_observability(tmp_path_factory)


class FakeProc:
    _next_pid = [900000]   # far above any real pid

    def __init__(self):
        FakeProc._next_pid[0] += 1
        self.pid = FakeProc._next_pid[0]
        self.rc = None
        self.signals = []

    def poll(self):
        return self.rc

    def wait(self, timeout=None):
        return self.rc

    def send_signal(self, sig):
        self.signals.append(sig)
        if sig in (signal.SIGKILL, signal.SIGTERM):
            self.rc = -int(sig)

    def kill(self):
        self.send_signal(signal.SIGKILL)


class FakeReplica:
    def __init__(self):
        self.hang = False
        self.healthz_calls = 0
        self.closed = False

    def healthz(self, deadline_s=5.0):
        self.healthz_calls += 1
        if self.hang:
            raise socket.timeout('timed out')
        return {'ok': True}

    def close(self):
        self.closed = True


class Harness:
    """One supervisor of package `pkg` over fake children and a
    hand-cranked clock; `transcript()` reads back what it did."""

    def __init__(self, pkg, run_dir, **sup_kw):
        self.obs, mod = PKG[pkg]
        self.mod = mod
        self.now = [0.0]
        self.procs, self.replicas, self.spawned_at = [], [], []
        self.restarted = []
        kw = dict(heartbeat_interval_s=1.0, heartbeat_timeout_s=3.0,
                  backoff_base_s=1.0, backoff_mult=2.0,
                  backoff_cap_s=30.0, backoff_jitter=0.25,
                  max_restarts=3, restart_window_s=60.0)
        kw.update(sup_kw)
        log = self.obs.get_event_log().events()
        self.seq0 = log[-1]['seq'] if log else 0
        self.sup = mod.Supervisor(
            str(run_dir), mod.ReplicaSpec('fake:factory'),
            clock=lambda: self.now[0], sleep=lambda s: None,
            popen_fn=self._popen, connect_fn=self._connect,
            on_restart=lambda name, r: self.restarted.append(name), **kw)

    def _popen(self, argv, env, log_path):
        proc = FakeProc()
        self.procs.append(proc)
        self.spawned_at.append(self.now[0])
        return proc

    def _connect(self, child):
        r = FakeReplica()
        self.replicas.append(r)
        return r

    def tick(self, dt=1.0):
        self.now[0] += dt
        return self.sup.poll()

    def state(self, name='a'):
        return self.sup.stats()[name]['state']

    def transcript(self):
        pids = {}
        events = []
        for e in self.obs.get_event_log().events():
            if e.get('seq', 0) <= self.seq0 or \
                    e['name'] not in _SUPERVISOR_EVENTS:
                continue
            attrs = dict(e['attrs'])
            if 'pid' in attrs:
                attrs['pid'] = pids.setdefault(attrs['pid'], len(pids))
            events.append((e['name'], attrs))
        stats = {n: {k: v for k, v in s.items() if k not in ('pid', 'uid')}
                 for n, s in self.sup.stats().items()}
        return {'events': events, 'spawned_at': self.spawned_at,
                'signals': [p.signals for p in self.procs],
                'restarted': self.restarted, 'stats': stats,
                'files': sorted(os.listdir(self.sup.run_dir))}


# ---------------------------------------------------------------------------
# the fault scripts
# ---------------------------------------------------------------------------

def _clean_exit(h):
    h.sup.spawn('a')
    h.procs[-1].rc = 0
    h.tick()


def _nonzero_rc(h):
    h.sup.spawn('a')
    h.procs[-1].rc = 1
    h.tick()


def _signal_death(h):
    h.sup.spawn('a')
    h.procs[-1].rc = -int(signal.SIGKILL)
    h.tick()


def _hang(h):
    h.sup.spawn('a')
    h.replicas[-1].hang = True
    h.tick(1.5)
    assert h.state() == h.mod.READY        # misses, deadline not passed
    h.tick(3.0)
    while h.state() == h.mod.BACKOFF:
        h.tick(0.5)


def _healthy(h):
    h.sup.spawn('a')
    for _ in range(10):
        h.tick()
    assert h.replicas[-1].healthz_calls >= 9


def _backoff(h):
    h.sup.spawn('a')
    for _ in range(6):
        h.procs[-1].rc = 1
        h.tick(0.001)
        spawned = len(h.procs)
        h.tick(0.001)
        assert len(h.procs) == spawned     # not before the gate
        while h.state() == h.mod.BACKOFF:
            h.tick(0.5)


def _forgiven(h):
    h.sup.spawn('a')
    h.procs[-1].rc = 1
    h.tick(0.001)
    while h.state() == h.mod.BACKOFF:
        h.tick(0.5)
    h.tick(25.0)


def _crash_loop(h):
    h.sup.spawn('a')
    for _ in range(10):
        if h.state() == h.mod.QUARANTINED:
            break
        if h.state() == h.mod.READY:
            h.procs[-1].rc = 1
        h.tick(0.3)
    for _ in range(5):
        h.tick(10.0)


def _slow_crashes(h):
    h.sup.spawn('a')
    for _ in range(6):
        h.procs[-1].rc = 1
        h.tick(0.001)
        while h.state() == h.mod.BACKOFF:
            h.tick(0.2)
        h.tick(20.0)


def _retire(h):
    h.sup.spawn('a')
    h.sup.spawn('b')
    h.sup.retire('a', deadline_s=1.0)
    for _ in range(3):
        h.tick(10.0)


def _never_ready(h):
    def bad_connect(child):
        raise TimeoutError('never became ready')
    h.sup.connect_fn = bad_connect
    with pytest.raises(TimeoutError):
        h.sup.spawn('a')


def _failing_respawns(h):
    h.sup.spawn('a')
    h.sup.connect_fn = lambda c: (_ for _ in ()).throw(
        TimeoutError('spawn wedged'))
    h.procs[-1].rc = 1
    for _ in range(12):
        if h.state() == h.mod.QUARANTINED:
            break
        h.tick(0.3)


SCRIPTS = {
    'clean_exit': (_clean_exit, {}),
    'nonzero_rc': (_nonzero_rc, {}),
    'signal_death': (_signal_death, {}),
    'hang': (_hang, {}),
    'healthy': (_healthy, {}),
    'backoff': (_backoff, dict(max_restarts=10, restart_window_s=10_000.0)),
    'forgiven': (_forgiven, dict(restart_window_s=20.0)),
    'crash_loop': (_crash_loop, dict(backoff_base_s=0.1,
                                     backoff_cap_s=0.2)),
    'slow_crashes': (_slow_crashes, dict(max_restarts=2,
                                         restart_window_s=5.0,
                                         backoff_base_s=0.1,
                                         backoff_cap_s=0.2)),
    'retire': (_retire, {}),
    'never_ready': (_never_ready, {}),
    'failing_respawns': (_failing_respawns, dict(max_restarts=2,
                                                 backoff_base_s=0.1,
                                                 backoff_cap_s=0.2)),
}


def _run(name, tmp_path):
    script, kw = SCRIPTS[name]
    out = {}
    for pkg in PKG:
        h = Harness(pkg, tmp_path / pkg, **kw)
        script(h)
        out[pkg] = h.transcript()
    return out


@pytest.mark.parametrize('name', sorted(SCRIPTS))
def test_both_supervisors_run_the_fault_script_alike(name, tmp_path):
    got = _run(name, tmp_path)
    assert got['torch'] == got['jax']
    assert got['torch']['events'], 'the script emitted nothing'


def _events(transcript, name):
    return [a for n, a in transcript['events'] if n == name]


def test_the_policy_the_jax_tests_pin_holds_in_the_port(tmp_path):
    """The JAX fault tests' own expectations, read off the port's
    transcripts."""
    t = {n: _run(n, tmp_path / n)['torch'] for n in SCRIPTS}
    assert _events(t['clean_exit'], 'replica_exit')[-1]['reason'] == \
        'clean_exit' and not _events(t['clean_exit'], 'replica_crash')
    assert t['clean_exit']['stats']['a']['state'] == psup.BACKOFF
    assert _events(t['signal_death'], 'replica_crash')[-1]['rc'] == -9
    hang = _events(t['hang'], 'replica_hang')
    assert hang and hang[-1]['silent_s'] >= 3.0
    assert signal.SIGKILL in t['hang']['signals'][0]
    assert _events(t['hang'], 'replica_crash')[-1]['reason'] == 'hang'
    backoffs = [a['backoff_s'] for a in _events(t['backoff'],
                                                'replica_restart')]
    assert len(backoffs) == 6
    for i, b in enumerate(backoffs):
        ideal = min(2.0 ** i, 30.0)
        assert ideal * 0.75 <= b <= ideal * 1.25, (i, b)
    assert t['forgiven']['stats']['a']['attempts'] == 0
    q = _events(t['crash_loop'], 'replica_quarantined')
    assert q and q[-1]['crashes_in_window'] == 4
    assert len(t['crash_loop']['spawned_at']) == 4
    assert t['crash_loop']['stats']['a']['state'] == psup.QUARANTINED
    assert 'a.json' not in t['crash_loop']['files']
    assert t['slow_crashes']['stats']['a']['state'] == psup.READY
    assert t['retire']['stats']['a']['state'] == psup.STOPPED
    assert len(t['retire']['spawned_at']) == 2
    assert t['never_ready']['stats']['a']['state'] == psup.STOPPED
    assert signal.SIGKILL in t['never_ready']['signals'][0]
    assert t['failing_respawns']['stats']['a']['state'] == psup.QUARANTINED


def test_the_spec_starts_the_ports_replica_main(tmp_path):
    spec = psup.ReplicaSpec('f.py:make', model_kwargs={'n': 1},
                            engine_kwargs={'num_slots': 2},
                            weight_store_dir='/w', weight_version=3,
                            spool_dir='/s', device='cpu')
    argv = spec.argv('python', '/r/a.sock', 'a-1', obs_scope='proc:a')
    assert argv[:3] == ['python', '-m',
                        'paddle_tpu_torch.serving.replica_main']
    opts = dict(zip(argv[3::2], argv[4::2]))
    assert opts == {'--socket': '/r/a.sock', '--model-spec': 'f.py:make',
                    '--model-kwargs': '{"n": 1}',
                    '--engine-kwargs': '{"num_slots": 2}',
                    '--device': 'cpu', '--uid': 'a-1',
                    '--drain-deadline-s': '30.0', '--weight-store': '/w',
                    '--weight-version': '3', '--spool': '/s',
                    '--obs-scope': 'proc:a'}
    assert psup.ReplicaSpec('f.py:make').device == 'cuda'


# ---------------------------------------------------------------------------
# orphan reaping, on real sleeping processes
# ---------------------------------------------------------------------------

def _sleeper(marker=None):
    argv = [sys.executable, '-c', 'import time; time.sleep(120)']
    proc = subprocess.Popen(argv + ([marker] if marker else []))
    if marker:      # wait out the fork -> exec window
        deadline = time.time() + 10
        while time.time() < deadline:
            try:
                with open(f'/proc/{proc.pid}/cmdline', 'rb') as f:
                    if marker.encode() in f.read():
                        break
            except OSError:
                pass
            time.sleep(0.01)
    return proc


def _pidfile(run_dir, name, pid, uid='stale-uid'):
    with open(os.path.join(run_dir, f'{name}.json'), 'w') as f:
        json.dump({'pid': pid, 'name': name, 'uid': uid,
                   'socket': os.path.join(run_dir, f'{name}.sock')}, f)


def _boot(run_dir, spool=None):
    psup.Supervisor(run_dir, psup.ReplicaSpec('fake:factory',
                                              spool_dir=spool),
                    popen_fn=lambda *a: FakeProc(),
                    connect_fn=lambda c: FakeReplica())


def test_a_live_orphan_of_the_port_is_killed_and_swept(tmp_path):
    run_dir, spool = str(tmp_path / 'run'), tmp_path / 'spool'
    os.makedirs(run_dir)
    orphan = _sleeper('paddle_tpu_torch.serving.replica_main')
    try:
        _pidfile(run_dir, 'old', orphan.pid, uid='dead-1')
        open(os.path.join(run_dir, 'old.sock'), 'w').close()
        os.makedirs(spool / 'dead-1')
        (spool / 'dead-1' / 'seg.bin').write_bytes(b'x')
        log = pobs.get_event_log().events()
        seq0 = log[-1]['seq'] if log else 0
        _boot(run_dir, str(spool))
        assert orphan.wait(timeout=10) == -int(signal.SIGKILL)
        reaped = [e for e in pobs.get_event_log().events()
                  if e['seq'] > seq0 and e['name'] == 'replica_orphan_reaped']
        assert reaped and reaped[-1]['attrs']['pid'] == orphan.pid
        assert os.listdir(run_dir) == []
        assert not (spool / 'dead-1').exists()
    finally:
        if orphan.poll() is None:
            orphan.kill()


@pytest.mark.parametrize('marker', [None, 'paddle_tpu.serving.replica_main'])
def test_a_process_that_is_not_the_ports_replica_is_spared(marker,
                                                            tmp_path):
    """A recycled pid, or a JAX-package replica: the stale pidfile is
    swept, the process lives."""
    run_dir = str(tmp_path / 'run')
    os.makedirs(run_dir)
    other = _sleeper(marker)
    try:
        _pidfile(run_dir, 'old', other.pid)
        _boot(run_dir)
        time.sleep(0.1)
        assert other.poll() is None
        assert os.listdir(run_dir) == []
    finally:
        other.kill()


def test_a_garbage_pidfile_is_swept_quietly(tmp_path):
    run_dir = str(tmp_path / 'run')
    os.makedirs(run_dir)
    with open(os.path.join(run_dir, 'junk.json'), 'w') as f:
        f.write('not json{{{')
    _boot(run_dir)
    assert os.listdir(run_dir) == []
