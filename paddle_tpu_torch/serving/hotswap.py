"""Versioned weights: the trainer -> serving weight store (counterpart of
`paddle_tpu/serving/hotswap.py`).

- `WeightStore`: versioned, sha256-manifested weight snapshots in the
  checkpoint integrity format (`utils.checkpoint.CheckpointManager`:
  atomic-rename commit, per-file checksums in `_COMMITTED`, corrupt
  payloads refused, never served). Versions are monotone; the last K are
  kept for rollback; a version that fails a health gate or its checksum
  is quarantined (a marker file) so no later poll offers it again. The
  on-disk layout (`step_<v>/tree.npz` + `_COMMITTED`, `_QUARANTINED`,
  `_WRITER.json`) is the JAX package's, so a version published by either
  package loads in the other.
- `WeightPublisher`: the trainer side. Snapshots a port `Layer`'s
  `state_dict()`, a zero-arg callable's `{name: array}` or anything with
  `capture_host_state()`, and publishes it under the next version.
- `finite_weights_gate`, `CanaryGate`: health gates for a swapped
  engine (`InferenceEngine.swap_weights` / `restore_weights`).

A loaded version's leaves are host arrays: numpy, except bf16 (and fp8)
ones, which are torch CPU tensors (`serialization.load(...,
return_numpy=True)`); `swap_weights` takes either.

One difference from the JAX package, where the port follows the
docstring of `finite_weights_gate` and not its code: the JAX gate tests
`np.issubdtype(a.dtype, np.floating)`, which is False for a bf16 leaf
(`ml_dtypes.bfloat16` has numpy kind 'V'), so it passes a bf16 NaN. The
port's gate checks every floating leaf, bf16 included (ROADMAP.md,
Queue 3).

Observability (the JAX store's): the events `weight_publish`,
`weight_version_quarantined` and `weight_writer_stale`, the counters
`paddle_weight_publish_total`, `paddle_weight_publish_bytes_total`,
`paddle_weight_writer_stale_total` and `paddle_swap_quarantined_total`,
and the `paddle_weight_published_version` gauge; a serving engine's
swap notes its `weight_version` (`/healthz`, `paddle_weight_version`).

- `ReplicaUpdater`: the serving side. Rolls a new version across a
  `Router`'s replicas one at a time (cordon, drain, swap, health gate,
  rejoin; a failed gate restores, quarantines and aborts), under the
  `hotswap.*` spans with `paddle_swap_total` / `_rollbacks_total` /
  `_seconds` and the `weight_swap_*` / `weight_rollback` events.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import observability as _obs
from .. import serialization
from ..utils.checkpoint import CheckpointManager


class WeightLoadError(RuntimeError):
    """A published version could not be loaded (missing, quarantined,
    or failed its sha256 manifest)."""


class SwapFailed(RuntimeError):
    """A rolling swap could not complete on a replica (drain timeout /
    unexpected engine failure). Gate failures do NOT raise: they roll
    back and quarantine."""

    def __init__(self, version: int, replica_id: int, msg: str):
        self.version = int(version)
        self.replica_id = int(replica_id)
        super().__init__(msg)


def _host_leaf(t):
    """One weight as host storage: a tensor as a CPU copy (it may be a
    live parameter that training mutates in place), anything else (a
    numpy array, or an array-like with `.value` or `__array__`) as a
    numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().to('cpu', copy=True)
    return np.asarray(getattr(t, 'value', t))


def _host_tree(state: Dict[str, Any]) -> Dict[str, Any]:
    """Materialize a {name: tensor|array} state on the host."""
    return {n: _host_leaf(t) for n, t in dict(state).items()}


# ---------------------------------------------------------------------------
# the versioned store
# ---------------------------------------------------------------------------

class WeightStore:
    """Versioned weight snapshots in the checkpoint integrity format:
    each version is a committed `step_<v>` directory (atomic rename, npz
    payload, per-file sha256 in `_COMMITTED`) managed by a
    `CheckpointManager`, plus quarantine on top: a version that fails a
    health gate or a checksum gets a `_QUARANTINED` marker and stops
    being offered by `latest_version()`/`load()`, while version
    numbering stays monotone past it.

    Cross-process safety: `publish` claims a `_WRITER.json` marker (pid,
    host and start time, atomic rename) for the duration of the commit.
    A publisher killed mid-commit leaves the marker and possibly a
    half-written `step_*.tmp` directory; the commit is an atomic rename,
    so the torn version is never offered, and the NEXT publisher finds
    the stale marker (dead pid, or `stale_writer_s` elapsed for a marker
    of another host), sweeps it and the orphan tmp directories, and
    proceeds. A marker whose pid is alive is a concurrent publisher: a
    loud error, not a silent last-writer-wins.

    Args:
        directory: store root (shared between trainer and servers: a
            filesystem both can reach is the transport).
        keep_versions: retention depth; rollback needs >= 2.
        retry_policy: the `RetryPolicy` of the store's I/O.
        stale_writer_s: age past which a writer marker is presumed dead
            when its pid cannot be probed (another host).
    """

    _MARKER = '_QUARANTINED'
    _WRITER = '_WRITER.json'

    def __init__(self, directory: str, keep_versions: int = 4,
                 retry_policy=None, stale_writer_s: float = 300.0):
        if keep_versions < 2:
            raise ValueError('keep_versions must be >= 2 (rollback '
                             'needs the previous version retained)')
        self.mgr = CheckpointManager(
            directory, backend='npz', max_to_keep=int(keep_versions),
            save_interval_steps=1, retry_policy=retry_policy)
        self.directory = self.mgr.directory
        self.stale_writer_s = float(stale_writer_s)
        reg = _obs.get_registry()
        self._m_published = reg.counter(
            'paddle_weight_publish_total', 'weight versions published')
        self._m_publish_bytes = reg.counter(
            'paddle_weight_publish_bytes_total',
            'host payload bytes published to the weight store')
        self._m_published_version = reg.gauge(
            'paddle_weight_published_version',
            'latest committed (non-quarantined) weight version')
        self._m_quarantined = reg.counter(
            'paddle_swap_quarantined_total',
            'weight versions quarantined (failed gate or load)')

    # -- bookkeeping --------------------------------------------------------
    def _dir(self, version: int) -> str:
        return self.mgr._step_dir(int(version))

    def all_versions(self) -> List[int]:
        """Every committed version, quarantined included (numbering)."""
        return self.mgr.all_steps()

    def versions(self) -> List[int]:
        """Committed, servable (non-quarantined) versions, ascending."""
        return [v for v in self.mgr.all_steps()
                if not self.is_quarantined(v)]

    def latest_version(self) -> Optional[int]:
        vs = self.versions()
        return vs[-1] if vs else None

    def next_version(self) -> int:
        vs = self.all_versions()
        return (vs[-1] + 1) if vs else 1

    def is_quarantined(self, version: int) -> bool:
        return os.path.exists(os.path.join(self._dir(version),
                                           self._MARKER))

    def quarantined(self) -> List[int]:
        return [v for v in self.mgr.all_steps() if self.is_quarantined(v)]

    # -- stale-writer detection ---------------------------------------------
    def _writer_path(self) -> str:
        return os.path.join(self.directory, self._WRITER)

    def writer_marker(self) -> Optional[Dict[str, Any]]:
        """The live writer marker, or None. An unreadable marker (a torn
        marker write) reads as {}: the claim path sweeps it like any dead
        writer's."""
        path = self._writer_path()
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    @staticmethod
    def _pid_alive(pid) -> Optional[bool]:
        """True/False when the pid can be probed on THIS host, None when
        it cannot (another host shares the mount): age decides then."""
        try:
            pid = int(pid)
        except (TypeError, ValueError):
            return False
        try:
            os.kill(pid, 0)
            return True
        except ProcessLookupError:
            return False
        except PermissionError:
            return True      # exists, owned by someone else
        except OSError:
            return None

    def _sweep_stale_writer(self, marker: Dict[str, Any]):
        """Remove a dead publisher's droppings: the marker and any
        orphan step tmp directories. Committed versions are untouched:
        the atomic-rename commit means a killed writer can only leave
        uncommitted state behind."""
        swept = 0
        for name in sorted(os.listdir(self.directory)):
            if name.startswith('step_') and name.endswith('.tmp'):
                path = os.path.join(self.directory, name)
                shutil.rmtree(path, ignore_errors=True)
                swept += not os.path.exists(path)
        try:
            os.unlink(self._writer_path())
        except OSError:
            pass
        _obs.emit('weight_writer_stale', pid=marker.get('pid'),
                  started=marker.get('started'), swept_tmp=swept)
        if _obs.enabled():
            _obs.get_registry().counter(
                'paddle_weight_writer_stale_total',
                'dead mid-commit publishers detected and swept').inc()

    def _claim_writer(self, version: int):
        """Take the writer marker for this commit. A stale marker (dead
        pid, or older than stale_writer_s where the pid is unprobeable)
        is swept; a LIVE marker is a concurrent publisher and raises."""
        marker = self.writer_marker()
        if marker is not None:
            age = time.time() - float(marker.get('started', 0) or 0)
            alive = self._pid_alive(marker.get('pid'))
            same_host = marker.get('host', '') == os.uname().nodename
            if same_host and alive is not None:
                # the pid probe is authoritative on this host
                stale = not alive
            else:
                # another host (pid numbers don't travel) or an
                # unprobeable pid: age decides
                stale = age > self.stale_writer_s
            if not stale:
                raise RuntimeError(
                    f'weight store writer marker {self._writer_path()} '
                    f'belongs to a live publisher (pid '
                    f'{marker.get("pid")}, host '
                    f'{marker.get("host", "?")}, age {age:.0f}s); two '
                    f'live publishers on one store is a deployment bug '
                    f'- or raise stale_writer_s if this is a wedged '
                    f'remote writer')
            self._sweep_stale_writer(marker)
        tmp = f'{self._writer_path()}.{os.getpid()}.tmp'
        with open(tmp, 'w') as f:
            json.dump({'pid': os.getpid(), 'started': time.time(),
                       'host': os.uname().nodename,
                       'version': int(version)}, f)
        os.replace(tmp, self._writer_path())

    def _release_writer(self):
        try:
            os.unlink(self._writer_path())
        except OSError:
            pass

    # -- publish / load -----------------------------------------------------
    def publish(self, state: Dict[str, Any], version: Optional[int] = None,
                meta: Optional[Dict[str, Any]] = None) -> int:
        """Commit `state` ({name: tensor|array} model weights) as a new
        version. Versions are strictly monotone: an explicit `version`
        at or below the latest ever committed is a caller bug. The
        commit runs under the `_WRITER` marker (see the class
        docstring)."""
        host = _host_tree(state)
        if version is None:
            version = self.next_version()
        else:
            version = int(version)
            vs = self.all_versions()
            if vs and version <= vs[-1]:
                raise ValueError(
                    f'weight versions are monotone: {version} <= '
                    f'latest committed {vs[-1]}')
        nbytes = sum(int(a.nbytes) for a in host.values()
                     if hasattr(a, 'nbytes'))
        self._claim_writer(version)
        try:
            self.mgr.save(version,
                          {'model': host, 'weight_version': version,
                           'meta': dict(meta or {})}, force=True)
        finally:
            self._release_writer()
        _obs.emit('weight_publish', version=version, bytes=nbytes,
                  **{k: v for k, v in (meta or {}).items()
                     if isinstance(v, (int, float, str))})
        if _obs.enabled():
            self._m_published.inc()
            self._m_publish_bytes.inc(nbytes)
            self._m_published_version.set(version)
        return version

    def load(self, version: int) -> Dict[str, Any]:
        """Strict read of one exact version's weights: committed, not
        quarantined, and every payload file matching its sha256
        manifest, otherwise `WeightLoadError`. Deliberately NOT
        `CheckpointManager.restore`: no fall-back to the previous version
        (a swap must never apply another version than it announced)."""
        version = int(version)
        d = self._dir(version)
        if version not in self.mgr.all_steps():
            raise WeightLoadError(f'weight version {version} is not '
                                  f'committed under {self.directory}')
        if self.is_quarantined(version):
            raise WeightLoadError(f'weight version {version} is '
                                  f'quarantined')
        if not self.mgr.verify(version):
            raise WeightLoadError(
                f'weight version {version} failed its sha256 manifest '
                f'(torn write or bit rot)')
        tree = serialization.load(os.path.join(d, 'tree.npz'),
                                  return_numpy=True)
        return dict(tree['model'])

    def meta(self, version: int) -> Dict[str, Any]:
        tree = serialization.load(os.path.join(self._dir(int(version)),
                                               'tree.npz'),
                                  return_numpy=True)
        return dict(tree.get('meta', {}))

    # -- quarantine ---------------------------------------------------------
    def quarantine(self, version: int, reason: str = ''):
        """Mark `version` unservable (failed health gate / bad payload):
        `latest_version()`/`load()` stop offering it, retention still
        ages it out. Idempotent."""
        version = int(version)
        d = self._dir(version)
        already = self.is_quarantined(version)
        if os.path.isdir(d) and not already:
            with open(os.path.join(d, self._MARKER), 'w') as f:
                json.dump({'version': version, 'reason': str(reason),
                           'at': time.time()}, f)
        if not already:
            _obs.emit('weight_version_quarantined', version=version,
                      reason=str(reason))
            if _obs.enabled():
                self._m_quarantined.inc()
                latest = self.latest_version()
                if latest is not None:
                    self._m_published_version.set(latest)

    def stats(self) -> Dict[str, Any]:
        return {
            'directory': self.directory,
            'versions': self.versions(),
            'latest': self.latest_version(),
            'quarantined': self.quarantined(),
            'writer': self.writer_marker(),
        }


# ---------------------------------------------------------------------------
# trainer side
# ---------------------------------------------------------------------------

class WeightPublisher:
    """Streams a live training run's weights into a `WeightStore`
    every `interval_steps` optimizer steps.

    `source` is what to snapshot:
    - a port `Layer` (its `state_dict()`, copied to the host),
    - anything with `capture_host_state()` (its 'model' tree),
    - a zero-arg callable returning `{name: array}`.
    """

    def __init__(self, source, store: WeightStore,
                 interval_steps: int = 1,
                 meta_fn: Optional[Callable[[int], Dict[str, Any]]] = None):
        if interval_steps < 1:
            raise ValueError('interval_steps must be >= 1')
        self.source = source
        self.store = store
        self.interval_steps = int(interval_steps)
        self.meta_fn = meta_fn
        self.last_published_version: Optional[int] = None
        self.last_published_step: Optional[int] = None

    def capture(self) -> Dict[str, Any]:
        """One host snapshot of the source's weights; the one
        device-to-host moment of a publish, on the trainer's cadence."""
        src = self.source
        if callable(src) and not hasattr(src, 'state_dict') \
                and not hasattr(src, 'capture_host_state'):
            return _host_tree(src())
        if hasattr(src, 'capture_host_state'):
            return dict(src.capture_host_state()['model'])
        return _host_tree(src.state_dict())

    def publish(self, step: Optional[int] = None) -> int:
        """Snapshot + commit now; returns the new weight version."""
        meta: Dict[str, Any] = {'step': int(step)} if step is not None \
            else {}
        if self.meta_fn is not None:
            meta.update(self.meta_fn(step))
        version = self.store.publish(self.capture(), meta=meta)
        self.last_published_version = version
        self.last_published_step = step
        return version

    def maybe_publish(self, step: int) -> Optional[int]:
        """Publish when `step` lands on the interval (each step at most
        once); returns the version or None."""
        step = int(step)
        if step % self.interval_steps != 0:
            return None
        if self.last_published_step == step:
            return None
        return self.publish(step)


# ---------------------------------------------------------------------------
# health gates
# ---------------------------------------------------------------------------

def _finite(leaf) -> Optional[bool]:
    """Whether a floating leaf is finite; None for a non-floating one."""
    if isinstance(leaf, torch.Tensor):
        if not leaf.is_floating_point():
            return None
        return bool(torch.isfinite(leaf).all())
    a = np.asarray(leaf)
    if not np.issubdtype(a.dtype, np.floating):
        return None
    return bool(np.isfinite(a).all())


def finite_weights_gate(engine, version: int,
                        tree: Dict[str, Any]) -> Tuple[bool, str]:
    """Default gate: every floating leaf of the published tree is finite,
    bf16 included (a loaded bf16 leaf is a torch tensor). It reads the
    already-loaded host snapshot and never touches the device, so the
    swap captures nothing."""
    for name, leaf in tree.items():
        if _finite(leaf) is False:
            return False, f'non-finite values in {name!r}'
    return True, ''


class CanaryGate:
    """Opt-in post-swap probe: decode `max_new_tokens` greedily from
    `prompt` ON the freshly swapped (drained) engine and require it to
    finish, optionally matching `expect` token for token. The canary
    runs through the engine's own graphs, so its first run may capture a
    prefill bucket the live traffic never used; give it a prompt of a
    bucket the traffic uses when nothing may be captured."""

    def __init__(self, prompt: Sequence[int], max_new_tokens: int = 4,
                 expect: Optional[Sequence[int]] = None):
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.expect = None if expect is None else [int(t) for t in expect]

    def __call__(self, engine, version: int, tree) -> Tuple[bool, str]:
        from .api import SamplingParams
        h = engine.submit(self.prompt, SamplingParams(
            max_new_tokens=self.max_new_tokens, eos_token_id=-1))
        toks = h.result()
        if self.expect is not None and list(toks) != self.expect:
            return False, (f'canary mismatch: got {list(toks)}, '
                           f'expected {self.expect}')
        if not toks:
            return False, 'canary produced no tokens'
        return True, ''


# ---------------------------------------------------------------------------
# serving side
# ---------------------------------------------------------------------------

class ReplicaUpdater:
    """Rolls published weight versions across a `Router`'s replicas,
    one at a time, with zero dropped requests and zero recaptures (a
    copy of the JAX package's `ReplicaUpdater`).

    Each replica is cordoned (its scoped `weight_swap` degraded state
    takes it out of placement), drained by stepping the whole router,
    swapped (`engine.swap_weights`, an in-place copy into that replica's
    own parameters: `router.replica_model`), health-gated and rejoined;
    a failed gate restores its previous weights, quarantines the version
    and aborts the roll. Where the JAX updater counts new program-store
    keys and real XLA compiles across a swap, the port counts the
    swapped engine's new CUDA-graph captures (`stats()['traces']`):
    `new_program_keys` is the number of graphs captured for the first
    time, `real_compiles` the number of captures, and both stay 0.

    Args:
        router: the live `Router` (its replicas are the swap targets;
            its `step()` keeps the WHOLE fleet serving while one
            replica drains).
        store: the `WeightStore` the trainer publishes into.
        gates: health-gate callables `(engine, version, tree) ->
            (ok, detail)` run after the swap, before rejoin; the first
            failure reverts the replica and quarantines the version.
            Default: `[finite_weights_gate]`.
        max_drain_rounds: router rounds to wait for a replica to go
            idle before declaring the swap stuck (`SwapFailed`).
        traffic_pump: optional zero-arg callable invoked once per drain
            round — the hook tests (and request-generating callers) use
            to keep submitting traffic WHILE a swap is in flight.
    """

    def __init__(self, router, store: WeightStore, *,
                 gates: Optional[Sequence[Callable]] = None,
                 max_drain_rounds: int = 100000,
                 traffic_pump: Optional[Callable[[], None]] = None):
        self.router = router
        self.store = store
        self.gates = list(gates) if gates is not None \
            else [finite_weights_gate]
        self.max_drain_rounds = int(max_drain_rounds)
        self.traffic_pump = traffic_pump
        reg = _obs.get_registry()
        self._m_swaps = reg.counter(
            'paddle_swap_total', 'per-replica weight swaps by outcome',
            ('outcome',))
        self._m_rollbacks = reg.counter(
            'paddle_swap_rollbacks_total',
            'replicas reverted to their previous weights after a '
            'failed health gate')
        self._m_seconds = reg.histogram(
            'paddle_swap_seconds',
            'per-replica drain+swap+verify+rejoin wall time')

    # -- introspection ------------------------------------------------------
    def current_versions(self) -> Dict[int, int]:
        return {r.id: r.engine.weight_version
                for r in self.router.replicas}

    @property
    def fleet_version(self) -> Optional[int]:
        """The single version every replica serves, or None while the
        fleet is mixed (mid-rollout)."""
        vs = set(self.current_versions().values())
        return vs.pop() if len(vs) == 1 else None

    # -- the rolling swap ---------------------------------------------------
    def poll(self) -> Optional[Dict[str, Any]]:
        """Swap to the store's latest servable version when any replica
        is behind it; returns the `update_to` result or None."""
        latest = self.store.latest_version()
        if latest is None:
            return None
        if all(r.engine.weight_version >= latest
               for r in self.router.replicas):
            return None
        return self.update_to(latest)

    def update_to(self, version: int) -> Dict[str, Any]:
        """Roll `version` across the fleet. One replica at a time; a
        gate failure quarantines the version and ABORTS the rollout —
        replicas not yet swapped never see a version another replica
        just rejected."""
        version = int(version)
        result: Dict[str, Any] = {'version': version,
                                  'outcome': 'completed', 'replicas': []}
        with _obs.span('hotswap.swap', version=version):
            with _obs.span('hotswap.load', version=version):
                try:
                    tree = self.store.load(version)
                except Exception as exc:
                    # a version that cannot even load is quarantined the
                    # same as one that fails its gate — no replica was
                    # touched, nothing to roll back
                    self.store.quarantine(version,
                                          f'load failed: {exc}')
                    if _obs.enabled():
                        self._m_swaps.labels(outcome='load_failed').inc()
                    result['outcome'] = 'load_failed'
                    result['error'] = f'{type(exc).__name__}: {exc}'
                    return result
            for replica in list(self.router.replicas):
                r = self._swap_replica(replica, version, tree)
                result['replicas'].append(r)
                if r['outcome'] == 'rolled_back':
                    result['outcome'] = 'aborted'
                    break
        return result

    def _drive_drain(self, engine) -> int:
        rounds = 0
        while engine.has_work:
            if self.traffic_pump is not None:
                self.traffic_pump()
            self.router.step()
            rounds += 1
            if rounds > self.max_drain_rounds:
                raise SwapFailed(
                    -1, -1, f'replica did not drain within '
                            f'{self.max_drain_rounds} router rounds')
        return rounds

    def _swap_replica(self, replica, version: int,
                      tree: Dict[str, Any]) -> Dict[str, Any]:
        eng = replica.engine
        from_version = eng.weight_version
        res: Dict[str, Any] = {
            'replica': replica.id, 'from_version': from_version,
            'to_version': version, 'outcome': 'completed',
            'drain_rounds': 0, 'new_program_keys': 0, 'real_compiles': 0,
        }
        if from_version == version:
            res['outcome'] = 'already_current'
            return res
        _obs.emit('weight_swap_begin', replica=replica.id,
                  from_version=from_version, to_version=version)
        # cordon: the scoped degraded state takes this replica out of
        # placement through the SAME machinery /healthz and the router
        # already share — in-flight and queued work keeps decoding
        _obs.note_degraded('weight_swap',
                           {'from_version': from_version,
                            'to_version': version}, scope=replica.scope)
        t0 = time.perf_counter()
        cleared = False
        try:
            with _obs.span('hotswap.drain', replica=replica.id,
                           version=version):
                try:
                    res['drain_rounds'] = self._drive_drain(eng)
                except SwapFailed as exc:
                    raise SwapFailed(version, replica.id,
                                     str(exc)) from None
            traces0 = dict(eng.stats()['traces'])
            with _obs.span('hotswap.load', replica=replica.id,
                           version=version):
                prev = eng.swap_weights(tree, version=version)
            ok, detail = True, ''
            with _obs.span('hotswap.verify', replica=replica.id,
                           version=version):
                for gate in self.gates:
                    try:
                        verdict = gate(eng, version, tree)
                        ok, detail = (verdict if isinstance(verdict,
                                                            tuple)
                                      else (bool(verdict), ''))
                    except Exception as exc:
                        ok = False
                        detail = f'{type(exc).__name__}: {exc}'
                    if not ok:
                        break
                # zero recaptures: the swap copies into the live
                # parameters, so no graph (gates included) is captured
                # again
                traces1 = eng.stats()['traces']
                res['new_program_keys'] = len(set(traces1) - set(traces0))
                res['real_compiles'] = int(sum(traces1.values())
                                           - sum(traces0.values()))
            if ok:
                with _obs.span('hotswap.rejoin', replica=replica.id,
                               version=version):
                    _obs.clear_degraded('weight_swap',
                                        scope=replica.scope)
                    cleared = True
                dt = time.perf_counter() - t0
                _obs.emit('weight_swap_complete', replica=replica.id,
                          from_version=from_version, to_version=version,
                          drain_rounds=res['drain_rounds'],
                          seconds=round(dt, 4))
                if _obs.enabled():
                    self._m_swaps.labels(outcome='completed').inc()
                    self._m_seconds.observe(dt)
            else:
                with _obs.span('hotswap.rollback', replica=replica.id,
                               version=version):
                    eng.restore_weights(prev)
                self.store.quarantine(version, detail)
                _obs.emit('weight_swap_failed', replica=replica.id,
                          version=version, reason=detail)
                _obs.emit('weight_rollback', replica=replica.id,
                          to_version=from_version)
                if _obs.enabled():
                    self._m_swaps.labels(outcome='rolled_back').inc()
                    self._m_rollbacks.inc()
                    self._m_seconds.observe(time.perf_counter() - t0)
                res['outcome'] = 'rolled_back'
                res['reason'] = detail
        finally:
            if not cleared:
                _obs.clear_degraded('weight_swap', scope=replica.scope)
        return res
