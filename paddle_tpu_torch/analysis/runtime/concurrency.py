"""Runtime concurrency sanitizer: lockdep-style lock-order tracking plus
an Eraser-style lockset race checker, on instrumented lock wrappers
(a copy of `paddle_tpu/analysis/runtime/concurrency.py`, under the same
lock names, kinds and modes).

The serving layer is concurrent: HTTP scrape threads, flight-recorder
listeners, SIGTERM drain handlers and store writers touch the registries,
stores and engines the driver thread mutates. This module sees what
actually happens:

- `Lock()` / `RLock()` / `Condition()` are drop-in wrappers around the
  `threading` primitives; every lock of the port's observability layer is
  allocated through them. Each wrapper carries a NAME (``Class.attr`` for
  instance locks, ``module.var`` for module-level ones, the JAX package's
  names), and while the sanitizer is enabled every acquire records into
  one process-global acquisition graph.
- Lock-order: acquiring B while holding A adds the edge A->B (keyed by
  lock NAME: every instance of ``SlidingWindow._lock`` is one node). An
  edge that closes a directed cycle is the ABBA report: two code paths
  took the same locks in opposite orders, even if they never deadlocked
  on this run. The witness carries both held-stacks.
- Re-entry: acquiring a non-reentrant `Lock` this thread already holds
  is a certain self-deadlock, so it raises `ConcurrencySanitizerError`
  in any enabled mode.
- Lockset (Eraser, Savage et al. SOSP'97): fields declared
  ``field = guarded_by('_lock')`` at class level are checked on every
  attribute access once a second thread has touched them; an empty
  candidate lockset with a write involved is a race report carrying
  both access stacks.

Reports flow through the observability layer: a `sanitizer_violation`
event (a flight-recorder trigger), `paddle_sanitizer_violations_total
{kind}`, and in strict mode a `ConcurrencySanitizerError` raised at the
offending acquire or access. `export_edges` writes the observed graph as
the JAX package's JSON artifact (version 1, a list of {from, to, thread,
stack} edges), and `load_edges` reads one back, from either package.

Modes (``FLAGS_concurrency_sanitizer`` / env, or `enable()`):
  'off'     wrappers delegate with one integer check of overhead;
  'report'  violations are counted + emitted, execution continues;
  'strict'  violations raise `ConcurrencySanitizerError`.

The metrics registry allocates its own lock here, so this module imports
nothing of the package at module scope except `flags`; observability is
reached lazily, behind a thread-local re-entrancy guard (reporting a
violation takes the very locks being sanitized).
"""
from __future__ import annotations

import json
import os
import sys
import threading
import traceback
from typing import Any, Dict, List, Optional, Set, Tuple

from ... import flags as _flags

MODE_OFF, MODE_REPORT, MODE_STRICT = 0, 1, 2
_MODE_NAMES = {'off': MODE_OFF, 'report': MODE_REPORT,
               'strict': MODE_STRICT}

# single-element list: reads are one index op on the hot path
_mode = [_MODE_NAMES.get(str(_flags.flag('FLAGS_concurrency_sanitizer')),
                         MODE_OFF)]

# violation kinds (the {kind} label on paddle_sanitizer_violations_total)
KIND_LOCK_ORDER = 'lock_order_cycle'
KIND_REENTRY = 'reentry'
KIND_LOCKSET = 'lockset_race'
KINDS = (KIND_LOCK_ORDER, KIND_REENTRY, KIND_LOCKSET)

#: frames kept per witness stack (acquisition sites, not full tracebacks)
STACK_DEPTH = 6


class ConcurrencySanitizerError(RuntimeError):
    """A concurrency violation under strict mode (or a certain
    self-deadlock under any enabled mode). Carries the violation kind
    and the witness dict the report machinery recorded."""

    def __init__(self, kind: str, message: str,
                 witness: Optional[Dict[str, Any]] = None):
        self.kind = kind
        self.witness = witness or {}
        super().__init__(f'[{kind}] {message}')


class _ThreadState(threading.local):
    def __init__(self):
        self.held: List['SanitizedLock'] = []
        self.in_report = False


_tls = _ThreadState()

# process-global sanitizer state; guarded by a RAW lock — the one lock
# in the tree that cannot be sanitized with itself
_state_lock = threading.Lock()
_graph: Dict[str, Set[str]] = {}                 # name -> successors
_edge_witness: Dict[Tuple[str, str], Dict[str, Any]] = {}
_violations: List[Dict[str, Any]] = []
_reported: Set[str] = set()                      # dedup keys


def _stack(skip: int = 2) -> List[str]:
    """Compact acquisition-site witness: 'file:line in fn' frames,
    innermost last, sanitizer frames trimmed. BOUNDED extraction
    (STACK_DEPTH frames from the caller, not the whole stack): a full
    extract_stack under a deep test-harness stack costs hundreds of
    microseconds, and witnesses are only worth capturing at report /
    new-edge time anyway."""
    frames = traceback.extract_stack(sys._getframe(skip), STACK_DEPTH)
    return [f'{os.path.basename(f.filename)}:{f.lineno} in {f.name}'
            for f in frames]


def _site(skip: int = 2) -> str:
    """One caller frame, no traceback machinery — the per-access
    bookkeeping cost the lockset checker pays on EVERY guarded access,
    so it must stay at raw-_getframe cost."""
    f = sys._getframe(skip)
    return (f'{os.path.basename(f.f_code.co_filename)}:{f.f_lineno} '
            f'in {f.f_code.co_name}')


def _thread_label() -> str:
    t = threading.current_thread()
    return f'{t.name}({t.ident})'


def _report(kind: str, dedup_key: str, message: str,
            witness: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Record one violation (deduped per site, lockdep-style: the first
    report per cycle/field is the signal; a storm of repeats is noise).
    Returns the violation dict when it was newly reported. Raises in
    strict mode; re-entry raises in any enabled mode (callers pass
    `always_raise`)."""
    with _state_lock:
        if dedup_key in _reported:
            return None
        _reported.add(dedup_key)
        violation = {'kind': kind, 'message': message,
                     'thread': _thread_label(), **witness}
        _violations.append(violation)
    # the report machinery takes sanitized locks (registry, event log);
    # the thread-local guard keeps the sanitizer out of its own way
    _tls.in_report = True
    try:
        from ... import observability as _obs
        if _obs.enabled():
            _obs.get_registry().counter(
                'paddle_sanitizer_violations_total',
                'concurrency-sanitizer violations by kind (lock-order '
                'cycle, non-reentrant re-entry, lockset race)',
                ('kind',)).labels(kind=kind).inc()
            _obs.emit('sanitizer_violation', kind=kind, message=message,
                      **{k: v for k, v in witness.items()
                         if isinstance(v, (str, int, float, list))})
    except Exception:
        # reporting must never mask the violation: it is already recorded
        # in _violations
        pass
    finally:
        _tls.in_report = False
    return violation


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """Directed path src -> dst in the acquisition graph (callers hold
    _state_lock). Iterative DFS; returns the node list or None."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        for nxt in _graph.get(node, ()):
            if nxt == dst:
                return path + [dst]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


class SanitizedLock:
    """Instrumented `threading.Lock`/`RLock`. Drop-in: acquire/release/
    locked/context manager. `name` keys the lock's CLASS in the
    acquisition graph ('MetricsRegistry._lock', 'server._live_lock')."""

    __slots__ = ('name', 'kind', '_inner')

    _REENTRANT = False

    def __init__(self, name: str = ''):
        self.name = name or f'anonymous@{id(self):x}'
        self.kind = 'RLock' if self._REENTRANT else 'Lock'
        if self._REENTRANT:
            self._inner = threading.RLock()
        else:
            self._inner = threading.Lock()

    # -- tracking ------------------------------------------------------
    def _before_acquire(self):
        held = _tls.held
        if not self._REENTRANT and any(h is self for h in held):
            # a certain self-deadlock: raise in ANY enabled mode —
            # "report-only" must not mean "report, then hang forever"
            v = _report(
                KIND_REENTRY, f'reentry::{self.name}::{_stack()[-1]}',
                f're-entry on non-reentrant {self.name} — this thread '
                f'already holds it; the acquire would self-deadlock',
                {'lock': self.name, 'stack': _stack()})
            raise ConcurrencySanitizerError(
                KIND_REENTRY,
                f're-entry on non-reentrant {self.name}',
                v or {'lock': self.name})
        new_edges = []
        for h in held:
            if h is self or h.name == self.name:
                # same lock class nested (two instances of the same
                # wrapper name, or an RLock re-acquire): not an order
                # edge — a self-edge would report every RLock re-entry
                # as a cycle
                continue
            with _state_lock:
                succ = _graph.setdefault(h.name, set())
                if self.name in succ:
                    continue
                succ.add(self.name)
                _edge_witness[(h.name, self.name)] = {
                    'held': h.name, 'acquired': self.name,
                    'thread': _thread_label(), 'stack': _stack(3)}
                new_edges.append(h.name)
        for src in new_edges:
            self._check_cycle(src)

    def _check_cycle(self, src: str):
        """The new edge src -> self.name just landed; a path
        self.name -> src means two orders coexist."""
        with _state_lock:
            path = _find_path(self.name, src)
            if path is None:
                return
            cycle = tuple(path)  # self.name ... src (+ back via new edge)
            i = cycle.index(min(cycle))
            canon = cycle[i:] + cycle[:i]
            witnesses = {}
            for a, b in zip(path, path[1:] + [path[0]]):
                w = _edge_witness.get((a, b))
                if w is not None:
                    witnesses[f'{a}->{b}'] = {
                        'thread': w['thread'], 'stack': w['stack']}
        pretty = ' -> '.join(canon + (canon[0],))
        v = _report(
            KIND_LOCK_ORDER, f'cycle::{"|".join(canon)}',
            f'lock-order cycle: {pretty} — two code paths take these '
            f'locks in opposite orders; pick one global order',
            {'cycle': list(canon), 'witnesses': witnesses})
        if v is not None and _mode[0] >= MODE_STRICT:
            raise ConcurrencySanitizerError(
                KIND_LOCK_ORDER, f'lock-order cycle: {pretty}', v)

    # -- the threading.Lock surface ------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        if _mode[0] and not _tls.in_report:
            self._before_acquire()
            got = self._inner.acquire(blocking, timeout)
            if got:
                _tls.held.append(self)
            return got
        return self._inner.acquire(blocking, timeout)

    def release(self):
        if _mode[0] and not _tls.in_report:
            held = _tls.held
            for i in range(len(held) - 1, -1, -1):
                if held[i] is self:
                    del held[i]
                    break
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def held_by_current_thread(self) -> bool:
        """Sanitizer's view (only meaningful while enabled)."""
        return any(h is self for h in _tls.held)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def __repr__(self):
        return f'{type(self).__name__}({self.name!r})'


class SanitizedRLock(SanitizedLock):
    __slots__ = ()
    _REENTRANT = True

    def locked(self) -> bool:
        # threading.RLock has no .locked() before 3.12; emulate via a
        # non-blocking probe (true when another thread holds it or we
        # do — callers only use this diagnostically)
        if self._inner.acquire(blocking=False):
            self._inner.release()
            return False
        return True


def Lock(name: str = '') -> SanitizedLock:
    """Instrumented non-reentrant lock. Name it 'Class.attr' (instance
    locks) or 'module.var' (module-level), the JAX package's names."""
    return SanitizedLock(name)


def RLock(name: str = '') -> SanitizedRLock:
    """Instrumented reentrant lock (same naming convention as Lock)."""
    return SanitizedRLock(name)


class SanitizedCondition:
    """Condition variable over a sanitized lock: acquire/release go
    through the wrapper (tracked); wait/notify delegate to a real
    `threading.Condition` built on the wrapper's inner primitive.
    While a thread is blocked in `wait()` its held-stack still lists
    the lock — it records no accesses while blocked, and holds the
    lock again the moment wait returns, so the approximation is
    sound for every check the sanitizer runs."""

    __slots__ = ('name', '_lock', '_cond')

    def __init__(self, lock: Optional[SanitizedLock] = None,
                 name: str = ''):
        if lock is None:
            lock = RLock(name=f'{name or "Condition"}.lock')
        if not isinstance(lock, SanitizedLock):
            raise TypeError(
                'SanitizedCondition needs a sanitized Lock/RLock '
                f'(got {type(lock).__name__}); allocate it via '
                'analysis.runtime.Lock/RLock')
        self.name = name or lock.name
        self._lock = lock
        self._cond = threading.Condition(lock._inner)

    def acquire(self, *a, **kw):
        return self._lock.acquire(*a, **kw)

    def release(self):
        self._lock.release()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()

    def wait(self, timeout: Optional[float] = None):
        return self._cond.wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        return self._cond.wait_for(predicate, timeout)

    def notify(self, n: int = 1):
        self._cond.notify(n)

    def notify_all(self):
        self._cond.notify_all()

    def __repr__(self):
        return f'SanitizedCondition({self.name!r})'


def Condition(lock: Optional[SanitizedLock] = None,
              name: str = '') -> SanitizedCondition:
    """Instrumented condition variable (see SanitizedCondition)."""
    return SanitizedCondition(lock, name=name)


# ---------------------------------------------------------------------------
# Eraser-style lockset checking: @guarded_by fields
# ---------------------------------------------------------------------------

class guarded_by:
    """Class-level field declaration: every access to the field must
    hold (one of) the named sanitized lock attribute(s)::

        class FlightRecorder:
            _steps = guarded_by('_lock', mutable=True)

    The value lives in the instance ``__dict__`` under a private slot;
    with the sanitizer off, access is one dict lookup. With it on, the
    Eraser state machine runs per (instance, field):

      virgin -> owned (allocating thread only; ``__init__`` writes
      before the object is shared are the warmup and never checked)
      -> shared from the first access by a second thread; thereafter
      EVERY access intersects the candidate lockset (initially the
      declared guard instances) with the accessing thread's held set.
      Empty intersection with a write involved = `lockset_race`,
      reported with both access stacks.

    ``mutable=True`` treats reads as writes — for container fields
    (deques, dicts) whose mutation happens through methods the
    descriptor can only see as reads.
    """

    def __init__(self, *lock_attrs: str, mutable: bool = False):
        if not lock_attrs:
            raise ValueError('guarded_by needs at least one lock attr')
        self.lock_attrs = tuple(lock_attrs)
        self.mutable = bool(mutable)
        self._name = '<unbound>'
        self._slot = None
        self._state_slot = None
        self._owner = None

    def __set_name__(self, owner, name):
        self._name = name
        self._owner = owner.__name__
        self._slot = f'_gb_value_{name}'
        self._state_slot = f'_gb_state_{name}'

    # -- the Eraser state machine --------------------------------------
    def _check(self, obj, write: bool):
        tid = threading.get_ident()
        d = obj.__dict__
        st = d.get(self._state_slot)
        # ONE frame per access (raw _getframe); the full bounded stack
        # is only extracted when a report actually fires
        site = _site(3)
        if st is None:
            st = d[self._state_slot] = {
                'first_tid': tid, 'shared': False, 'lockset': None,
                'write_seen': False, 'last': None}
        if tid != st['first_tid']:
            st['shared'] = True
        if st['shared']:
            declared = set()
            for attr in self.lock_attrs:
                lk = getattr(obj, attr, None)
                if isinstance(lk, SanitizedLock):
                    declared.add(id(lk))
            held = {id(h) for h in _tls.held}
            lockset = st['lockset']
            if lockset is None:
                lockset = declared
            lockset &= held
            st['lockset'] = lockset
            st['write_seen'] = st['write_seen'] or write
            if not lockset and st['write_seen']:
                field = f'{self._owner}.{self._name}'
                prev = st['last']
                v = _report(
                    KIND_LOCKSET, f'lockset::{field}',
                    f'{field} accessed without its declared guard '
                    f'{self.lock_attrs} after becoming shared — '
                    f'candidate lockset is empty (a data race)',
                    {'field': field, 'guards': list(self.lock_attrs),
                     'access': 'write' if write else 'read',
                     'stack': _stack(3),      # full witness, report-time only
                     'other_access': dict(prev) if prev else None})
                if v is not None and _mode[0] >= MODE_STRICT:
                    st['last'] = {'thread': _thread_label(),
                                  'access': 'write' if write else 'read',
                                  'stack': [site]}
                    raise ConcurrencySanitizerError(
                        KIND_LOCKSET, f'lockset race on {field}', v)
        st['last'] = {'thread': _thread_label(),
                      'access': 'write' if write else 'read',
                      'stack': [site]}

    # -- descriptor protocol -------------------------------------------
    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        if _mode[0] and not _tls.in_report:
            self._check(obj, write=self.mutable)
        try:
            return obj.__dict__[self._slot]
        except KeyError:
            raise AttributeError(
                f'{self._owner}.{self._name} accessed before first '
                f'assignment') from None

    def __set__(self, obj, value):
        if _mode[0] and not _tls.in_report:
            self._check(obj, write=True)
        obj.__dict__[self._slot] = value

    def __delete__(self, obj):
        obj.__dict__.pop(self._slot, None)
        obj.__dict__.pop(self._state_slot, None)


# ---------------------------------------------------------------------------
# mode control + introspection
# ---------------------------------------------------------------------------

def mode() -> str:
    return {v: k for k, v in _MODE_NAMES.items()}[_mode[0]]


def enable(new_mode: str = 'report'):
    """Switch the sanitizer mode ('off' | 'report' | 'strict'); mirrors
    into FLAGS_concurrency_sanitizer."""
    if new_mode not in _MODE_NAMES:
        raise ValueError(
            f'mode must be one of {sorted(_MODE_NAMES)}, got {new_mode!r}')
    _mode[0] = _MODE_NAMES[new_mode]
    _flags.set_flags({'FLAGS_concurrency_sanitizer': new_mode})


def disable():
    enable('off')


class sanitized:
    """Context manager scoping a sanitizer mode (tests, gauntlets)::

        with concurrency.sanitized('strict'):
            run_chaos()
    """

    def __init__(self, new_mode: str = 'report'):
        self._new = new_mode
        self._prev = mode()

    def __enter__(self):
        self._prev = mode()
        enable(self._new)
        return self

    def __exit__(self, *exc):
        enable(self._prev)


def violations(kind: Optional[str] = None) -> List[Dict[str, Any]]:
    """Violations recorded since the last reset (all kinds, or one)."""
    with _state_lock:
        out = list(_violations)
    if kind is not None:
        out = [v for v in out if v['kind'] == kind]
    return out


def reset():
    """Clear the acquisition graph, violation list, and report dedup —
    NOT the mode. Tests call this to isolate edge history; production
    never should (the accumulated graph IS the lockdep value)."""
    with _state_lock:
        _graph.clear()
        _edge_witness.clear()
        _violations.clear()
        _reported.clear()


def observed_edges() -> List[Dict[str, Any]]:
    """The acquisition graph as a list of {'from','to','thread','stack'}
    edge dicts (the JSON artifact's payload)."""
    with _state_lock:
        out = []
        for (a, b), w in sorted(_edge_witness.items()):
            out.append({'from': a, 'to': b, 'thread': w['thread'],
                        'stack': list(w['stack'])})
        return out


def stats() -> Dict[str, Any]:
    """Sanitizer posture + counters (debug summary / tests)."""
    with _state_lock:
        nodes = set(_graph)
        for succ in _graph.values():
            nodes |= succ
        by_kind = {k: 0 for k in KINDS}
        for v in _violations:
            by_kind[v['kind']] = by_kind.get(v['kind'], 0) + 1
        return {'mode': mode(), 'lock_classes': len(nodes),
                'edges': len(_edge_witness),
                'violations': dict(by_kind)}


def export_edges(path: str) -> str:
    """Write the observed acquisition edges as the JSON artifact a static
    lock-order pass merges (the JAX package's `load_edges` reads it).
    Returns the path."""
    doc = {'version': 1, 'tool': 'paddle_tpu_torch.analysis.runtime',
           'edges': observed_edges()}
    tmp = f'{path}.tmp'
    with open(tmp, 'w') as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)
    return path


def load_edges(path: str) -> List[Dict[str, Any]]:
    """Read an `export_edges` artifact back (raises on malformed input: a
    lint consuming garbage must say so)."""
    with open(path) as f:
        doc = json.load(f)
    edges = doc.get('edges')
    if not isinstance(edges, list):
        raise ValueError(f'{path}: not a runtime-edges artifact '
                         f'(missing "edges" list)')
    for e in edges:
        if not (isinstance(e, dict) and 'from' in e and 'to' in e):
            raise ValueError(f'{path}: malformed edge entry {e!r}')
    return edges
