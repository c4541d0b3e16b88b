"""Step-indexed training checkpoints (counterpart of
`paddle_tpu/utils/checkpoint.py`; upstream: fleet checkpointing + the
hapi Checkpoint callback).

One `CheckpointManager` over the containers of `serialization.py`: a
checkpoint is a tree ({'params', 'opt_state', 'step', 'meta', ...}) of
tensors, arrays and scalars, committed as `step_<n>/tree.npz` (backend
'npz') or `step_<n>/tree_sharded/` (backend 'native', `save_sharded`
through the host C++ shard writer) plus a `_COMMITTED` manifest holding
each payload file's sha256 (atomic rename, so a killed writer never
leaves a half-offered step). The layouts are the JAX package's, so
either package restores the other's checkpoints.

Backends: 'npz' by default; `backend='native'` needs the shard writer
(`utils/ckpt_native.available()`) and raises the JAX manager's
RuntimeError without it; `backend='orbax'` raises as the JAX manager does
when orbax is missing (the port does not use orbax).

Observability (the JAX manager's): each save runs in a `checkpoint_save`
span and each restore in a `checkpoint_restore` span (the goodput
ledger's categories of the same names), counted with their payload bytes
in `paddle_checkpoint_saves_total` / `_save_bytes_total` /
`_restores_total` / `_restore_bytes_total`; a step skipped on a checksum
mismatch emits `checkpoint_corrupt` (a flight-recorder trigger) and
counts in `paddle_checkpoint_corrupt_total`.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import observability as _obs
from .. import serialization
from ..resilience.retry import RetryPolicy, call_with_retry

_STEP_RE = re.compile(r'^step_(\d+)$')


def _payload_checksums(d: str) -> Dict[str, str]:
    """sha256 of every payload file under a checkpoint dir (the
    _COMMITTED manifest itself excluded), keyed by relative path."""
    out: Dict[str, str] = {}
    for root, _, files in os.walk(d):
        for name in sorted(files):
            if name == '_COMMITTED':
                continue
            path = os.path.join(root, name)
            h = hashlib.sha256()
            with open(path, 'rb') as f:
                for chunk in iter(lambda: f.read(1 << 20), b''):
                    h.update(chunk)
            out[os.path.relpath(path, d)] = h.hexdigest()
    return out


def _tree_bytes(tree: Any) -> int:
    """Payload size of a host tree (the leaves with `nbytes`: arrays and
    tensors)."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    nbytes = getattr(tree, 'nbytes', None)
    return int(nbytes) if nbytes is not None else 0


def _to_host(tree: Any) -> Any:
    """A host snapshot of `tree`: every tensor copied to a CPU tensor
    (a copy even of a CPU tensor, since training mutates its tensors in
    place), arrays, numpy scalars and Python numbers as numpy arrays (as
    the JAX manager's `_to_host` makes them), dict/list/tuple walked,
    other leaves (strings, None) as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to('cpu', copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if hasattr(tree, 'shape') or isinstance(tree, (int, float)):
        return np.asarray(tree)
    return tree


class CheckpointManager:
    """Save/restore step-indexed checkpoints with retention.

    Args mirror the JAX manager's (max_to_keep, save_interval_steps,
    async_save, backend, retry_policy); the backend is 'npz' unless
    'native' is asked for.
    """

    def __init__(self, directory: str, max_to_keep: int = 5,
                 save_interval_steps: int = 1, async_save: bool = False,
                 backend: Optional[str] = None,
                 retry_policy: Optional[RetryPolicy] = None):
        if backend == 'orbax':
            raise RuntimeError('orbax backend requested but not importable')
        if backend == 'native':
            from . import ckpt_native
            if not ckpt_native.available():
                raise RuntimeError(
                    'native backend requested but the C++ checkpoint '
                    'sharder is unavailable (no compiler?)')
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.async_save = async_save
        self.backend = 'native' if backend == 'native' else 'npz'
        self._pending: Optional[threading.Thread] = None
        # transient I/O failures (flaky mounts) are retried with backoff
        # before a save/restore is declared dead
        self._retry_policy = retry_policy or RetryPolicy()
        self._writer_exc: Optional[BaseException] = None

    # -- bookkeeping --------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f'step_{step}')

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(
                    os.path.join(self.directory, name, '_COMMITTED')):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        return step % self.save_interval_steps == 0

    # -- save/restore -------------------------------------------------------
    def _write_once(self, step: int, host_tree: Any, cursor=None):
        """One write attempt: tmp dir -> serialize -> commit marker ->
        atomic rename. Re-entrant (the tmp dir is recreated), so the
        retry wrapper can re-run it after a transient failure."""
        d = self._step_dir(step)
        tmp = d + '.tmp'
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        if self.backend == 'native':
            serialization.save_sharded(host_tree,
                                       os.path.join(tmp, 'tree_sharded'))
        else:
            serialization.save(host_tree, os.path.join(tmp, 'tree.npz'))
        committed = {'step': step, 'backend': self.backend,
                     'checksums': _payload_checksums(tmp)}
        if cursor is not None:
            committed['dataloader'] = cursor
        with open(os.path.join(tmp, '_COMMITTED'), 'w') as f:
            json.dump(committed, f)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.replace(tmp, d)
        self._gc()

    def _write(self, step: int, host_tree: Any, cursor=None):
        nbytes = _tree_bytes(host_tree)
        with _obs.span('checkpoint_save', step=step, bytes=nbytes):
            call_with_retry(self._write_once, step, host_tree, cursor,
                            policy=self._retry_policy,
                            site='checkpoint_save')
        if _obs.enabled():
            reg = _obs.get_registry()
            reg.counter('paddle_checkpoint_saves_total',
                        'committed checkpoint saves').inc()
            reg.counter('paddle_checkpoint_save_bytes_total',
                        'checkpoint payload bytes written').inc(nbytes)

    def save(self, step: int, tree: Any, force: bool = False,
             dataloader: Any = None):
        """Snapshot `tree` at `step`. Respects save_interval unless forced.

        Pass `dataloader=` to record its mid-epoch cursor (its
        `state_dict()`) in the _COMMITTED sidecar, outside the tree."""
        if not force and not self.should_save(step):
            return False
        cursor = dataloader.state_dict() if dataloader is not None else None
        self.wait_until_finished()
        # the host copy is taken HERE, before any writer thread starts:
        # the train loop mutates its tensors in place, so a copy taken in
        # the writer would tear the checkpoint across steps
        host_tree = _to_host(tree)
        if self.async_save:
            # the writer thread must not swallow failures: capture the
            # exception and re-raise it from wait_until_finished() / the
            # next save()
            def _write_capturing():
                try:
                    self._write(step, host_tree, cursor)
                except BaseException as e:
                    self._writer_exc = e
            self._pending = threading.Thread(
                target=_write_capturing, daemon=True)
            self._pending.start()
        else:
            self._write(step, host_tree, cursor)
        return True

    def verify(self, step: int) -> bool:
        """Recompute the payload checksums of a committed step against
        its _COMMITTED manifest. Manifests from before checksumming
        (no 'checksums' key) pass vacuously."""
        d = self._step_dir(step)
        try:
            with open(os.path.join(d, '_COMMITTED')) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return False
        want = meta.get('checksums')
        if want is None:
            return True
        return _payload_checksums(d) == want

    def restore(self, step: Optional[int] = None,
                template: Any = None, dataloader: Any = None) -> Any:
        """Load a checkpoint tree (host leaves, `load(...,
        return_numpy=True)`); with `dataloader=`, also push the cursor
        saved in the _COMMITTED sidecar back into it. A checkpoint whose
        payload fails its manifest checksum (torn write, bit rot) is
        skipped and the previous committed step is restored instead;
        the cursor comes from the step actually restored. `template` is
        accepted for the JAX signature (it shapes orbax restores only)."""
        actual, tree = self._restore_tree(step)
        if dataloader is not None:
            with open(os.path.join(self._step_dir(actual),
                                   '_COMMITTED')) as f:
                meta = json.load(f)
            if 'dataloader' in meta:
                dataloader.set_state_dict(meta['dataloader'])
        return tree

    def _restore_tree(self, step: Optional[int] = None):
        self.wait_until_finished()
        steps = self.all_steps()
        if step is not None:
            steps = [s for s in steps if s <= step]
            if step not in steps:
                raise FileNotFoundError(
                    f'no committed checkpoint for step {step} under '
                    f'{self.directory}')
        if not steps:
            raise FileNotFoundError(
                f'no committed checkpoints under {self.directory}')
        for candidate in reversed(steps):
            if not self.verify(candidate):
                # half-written/corrupt payload: never restore it; fall
                # back to the previous committed step
                _obs.emit('checkpoint_corrupt', step=candidate,
                          directory=self._step_dir(candidate))
                if _obs.enabled():
                    _obs.get_registry().counter(
                        'paddle_checkpoint_corrupt_total',
                        'checkpoints skipped on checksum mismatch').inc()
                continue
            with _obs.span('checkpoint_restore', step=candidate):
                tree = call_with_retry(self._read_tree, candidate,
                                       policy=self._retry_policy,
                                       site='checkpoint_restore')
            if _obs.enabled():
                reg = _obs.get_registry()
                reg.counter('paddle_checkpoint_restores_total',
                            'checkpoint restores').inc()
                reg.counter('paddle_checkpoint_restore_bytes_total',
                            'checkpoint payload bytes read').inc(
                                _tree_bytes(tree))
            return candidate, tree
        raise RuntimeError(
            f'every committed checkpoint under {self.directory} failed '
            f'its checksum')

    def _read_tree(self, step: int) -> Any:
        d = self._step_dir(step)
        with open(os.path.join(d, '_COMMITTED')) as f:
            meta = json.load(f)
        if meta['backend'] == 'orbax':
            raise RuntimeError('checkpoint written by orbax but orbax '
                               'is unavailable')
        if meta['backend'] == 'native':
            return serialization.load_sharded(
                os.path.join(d, 'tree_sharded'), return_numpy=True)
        return serialization.load(os.path.join(d, 'tree.npz'),
                                  return_numpy=True)

    def wait_until_finished(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._writer_exc is not None:
            exc, self._writer_exc = self._writer_exc, None
            raise RuntimeError(
                'async checkpoint write failed (checkpoint NOT '
                'committed)') from exc

    def _gc(self):
        steps = self.all_steps()
        while len(steps) > self.max_to_keep:
            victim = steps.pop(0)
            shutil.rmtree(self._step_dir(victim), ignore_errors=True)
