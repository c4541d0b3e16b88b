"""Replica process entry point (a copy of
`paddle_tpu/serving/replica_main.py`):

    python -m paddle_tpu_torch.serving.replica_main --socket PATH \\
        --model-spec module:callable [--device cpu] ...

One invocation = one `InferenceEngine` in its own OS process, serving
the framed RPC protocol of `serving.remote` on an AF_UNIX socket. The
supervisor spawns this module; the parent talks to it through a
`RemoteReplica`. Startup, in order:

1. The device: `--device` (default `cuda`). Without a card a child that
   was not given `--device cpu` exits `EXIT_LOAD`: it never serves on
   the CPU by accident.
2. The model: the factory builds the architecture on the device
   (`factory(device=..., **model_kwargs)`), and the weights come from
   the stale-writer-safe `WeightStore` (sha256-verified at read);
   `swap_weights` stamps the version. No weight bytes cross the RPC
   socket.
3. The warm start. The JAX child configures its program store and
   loads every persisted executable; the port has no program store,
   so the child captures every CUDA graph it can replay instead
   (`InferenceEngine.preload_programs`: the decode round, or the
   speculation round, and each prefill bucket). Its kernels load from
   the libraries under `build/` (built by the parent in the same
   checkout; `ops._build.COMPILES` counts what this process had to
   compile). The ready-marks (the capture counts `stats()['traces']`,
   the compile count, a digest of the parameters) are taken then and
   shipped in `hello` and `stats`, so the parent can check that the
   serving window captured and compiled nothing.
4. `enable_graceful_drain` on SIGTERM (the drain under its deadline,
   then exit 0).
5. The `Shipper` starts last but one (metrics, events and spans spool to
   disk for the parent's `Aggregator`), and the socket binds last: a
   connectable socket is the readiness signal.

`healthz` answers on the connection's own thread without the engine
lock, so a heartbeat answers through a decode round or a swap.

Exit codes, which the supervisor classifies: 0 clean, 1 crash, 2 usage,
3 load failure.

The model factory is addressed as `module:callable` or
`/path/to/file.py:callable`; it takes `device` and the JSON
`--model-kwargs` and returns the model on that device (eval mode is
applied here).
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import threading
import time
import traceback
from typing import Any, Dict

EXIT_CLEAN = 0
EXIT_CRASH = 1
EXIT_USAGE = 2
EXIT_LOAD = 3


def _resolve_factory(spec: str):
    """`pkg.mod:fn` or `/path/file.py:fn` -> the callable."""
    target, sep, fn_name = spec.rpartition(':')
    if not sep or not target or not fn_name:
        raise ValueError(
            f'model spec must be "module:callable" or "file.py:callable", '
            f'got {spec!r}')
    if target.endswith('.py') or os.sep in target:
        import importlib.util
        mod_spec = importlib.util.spec_from_file_location(
            'paddle_tpu_torch_replica_factory', target)
        if mod_spec is None or mod_spec.loader is None:
            raise ImportError(f'cannot load factory file {target!r}')
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
    else:
        import importlib
        mod = importlib.import_module(target)
    fn = getattr(mod, fn_name, None)
    if fn is None:
        raise ImportError(f'{target!r} has no attribute {fn_name!r}')
    return fn


class _ReplicaServer:
    """Accept loop + per-connection dispatch threads over one engine.

    Engine-touching methods serialize on `_elock`; `healthz` answers
    WITHOUT it, by design — that is what lets the supervisor's
    heartbeat distinguish "busy decoding" (healthz answers) from
    "SIGSTOPped / wedged" (socket times out)."""

    def __init__(self, engine, listener: socket.socket, *,
                 weight_store=None, preempt=None,
                 drain_deadline_s: float = 30.0, uid: str = '',
                 marks=None):
        from .. import observability as _obs
        from ..analysis.runtime import concurrency as _concurrency
        self._obs = _obs
        self.engine = engine
        self.listener = listener
        self.weight_store = weight_store
        self.preempt = preempt
        self.drain_deadline_s = drain_deadline_s
        self.uid = uid
        self._elock = _concurrency.RLock('_ReplicaServer._elock')
        self._requests: Dict[int, Any] = {}   # rid -> engine handle
        self._final_sent: set = set()
        self._stop = threading.Event()
        self._drained = False
        # ready-marks (`ready_marks`): the warm-start guard's zero point
        self.marks = dict(marks or {})

    # -- request mirror bookkeeping ---------------------------------------
    def _updates(self) -> Dict[str, Any]:
        """Status/token deltas for every tracked request; a request's
        terminal status ships until the frame carrying it is SENT (the
        caller prunes after a successful send, so a torn response frame
        re-ships the final state on the next step)."""
        out = {}
        for rid, h in self._requests.items():
            upd: Dict[str, Any] = {'status': h.status,
                                   'tokens': list(h.tokens)}
            if h.weight_version is not None:
                upd['weight_version'] = h.weight_version
            if getattr(h, 'adapter_version', None) is not None:
                upd['adapter_version'] = h.adapter_version
            if h.error is not None:
                from ..resilience.retry import is_transient
                upd['error'] = {
                    'type': type(h.error).__name__,
                    'message': str(h.error),
                    'transient': is_transient(h.error),
                }
            out[str(rid)] = upd
        return out

    def _prune_done(self):
        for rid in [r for r, h in self._requests.items() if h.done]:
            if rid in self._final_sent:
                del self._requests[rid]
                self._final_sent.discard(rid)
            else:
                self._final_sent.add(rid)

    # -- RPC methods -------------------------------------------------------
    def rpc_hello(self, **_):
        eng = self.engine
        return {
            'pid': os.getpid(), 'uid': self.uid,
            'weight_version': eng.weight_version,
            'prefill_chunk_tokens': eng.prefill_chunk_tokens,
            'num_slots': eng.pool.num_slots,
            'max_length': eng.pool.max_length,
            'device': str(eng.device), **self.marks,
        }

    def rpc_submit(self, prompt_tokens=None, params=None, priority=None,
                   adapter_id=None, **_):
        from .remote import params_from_wire
        with self._elock:
            h = self.engine.submit(prompt_tokens,
                                   params=params_from_wire(params or {}),
                                   priority=priority,
                                   adapter_id=adapter_id)
            self._requests[h.request_id] = h
            return {'rid': h.request_id, 'status': h.status}

    def rpc_step(self, **_):
        with self._elock:
            t0 = time.perf_counter()
            progressed = self.engine.step() if self.engine.has_work else 0
            # reported so the parent's mirror ledger can split this
            # round into decode (child wall) vs rpc_transport (framing
            # + socket surplus measured around the call)
            step_wall = time.perf_counter() - t0
            out = {'progressed': progressed, 'updates': self._updates(),
                   'step_wall_s': step_wall}
            self._prune_done()
            return out

    def rpc_evict_all(self, **_):
        with self._elock:
            orphans = self.engine.evict_all()
            rids = [h.request_id for h in orphans]
            for rid in rids:
                self._requests.pop(rid, None)
                self._final_sent.discard(rid)
            return {'rids': rids}

    def rpc_begin_drain(self, **_):
        with self._elock:
            self.engine.begin_drain()
            return {'draining': True}

    def rpc_drain(self, deadline_s=None, **_):
        with self._elock:
            ok = self.engine.drain(deadline_s=deadline_s)
            out = {'ok': ok, 'updates': self._updates()}
            self._prune_done()
            return out

    def rpc_swap_weights(self, version=None, strict=True, **_):
        if self.weight_store is None:
            raise RuntimeError('replica process has no --weight-store; '
                               'cannot swap by version')
        with self._elock:
            prev_version = self.engine.weight_version
            state = self.weight_store.load(int(version))
            self.engine.swap_weights(state, version=int(version),
                                     strict=bool(strict))
            return {'weight_version': self.engine.weight_version,
                    'prev_version': prev_version}

    def rpc_healthz(self, **_):
        # NO engine lock: must answer while a decode block runs
        return {'ok': True, 'pid': os.getpid(), 'uid': self.uid,
                'draining': self.engine.draining,
                'weight_version': self.engine.weight_version,
                'states': sorted(self._obs.degraded_states().keys())}

    def rpc_stats(self, **_):
        from ..ops import _build
        from ..ops import kernels as _kernels
        with self._elock:
            out = self.engine.stats()
            out['launches'] = dict(_kernels.LAUNCHES)
        out['kernel_builds'] = _build.COMPILES
        out.update(self.marks)
        out['pid'] = os.getpid()
        out['uid'] = self.uid
        return out

    def rpc_set_obs_scope(self, scope=None, **_):
        self.engine.obs_scope = scope
        return {'scope': scope}

    def rpc_shutdown(self, **_):
        self._stop.set()
        return {'stopping': True}

    # -- serve loop --------------------------------------------------------
    def _dispatch(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        from ..resilience.retry import is_transient
        method = msg.get('method', '')
        fn = getattr(self, f'rpc_{method}', None)
        if fn is None:
            return {'error': {'type': 'KeyError',
                              'message': f'unknown RPC method {method!r}',
                              'transient': False}}
        try:
            return {'result': fn(**(msg.get('args') or {}))}
        except BaseException as exc:   # ships to the caller, typed
            return {'error': {'type': type(exc).__name__,
                              'message': str(exc),
                              'transient': is_transient(exc)}}

    def _serve_conn(self, conn: socket.socket):
        from .remote import recv_msg, send_msg
        try:
            while not self._stop.is_set():
                try:
                    msg = recv_msg(conn)
                except (ConnectionError, OSError, TimeoutError):
                    return   # peer gone; its mirrors survive parent-side
                send_msg(conn, self._dispatch(msg))
        finally:
            try:
                conn.close()
            except OSError:
                self._obs.count_suppressed('replica_conn_close')

    def serve_forever(self):
        """Accept until shutdown RPC or SIGTERM; then drain and return.
        Returns True when the drain (if any) beat its deadline."""
        self.listener.settimeout(0.2)
        threads = []
        while not self._stop.is_set():
            if self.preempt is not None and self.preempt.requested:
                break
            try:
                conn, _ = self.listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True,
                                 name='replica-rpc-conn')
            t.start()
            threads.append(t)
        # graceful exit: finish every accepted request under the deadline
        with self._elock:
            ok = True
            if self.engine.has_work or not self.engine.draining:
                ok = self.engine.drain(deadline_s=self.drain_deadline_s)
            self._drained = True
        self._stop.set()
        return ok


def ready_marks(engine) -> Dict[str, Any]:
    """What a replica shows the parent once it is warm: the capture
    counts (`traces`) and their total, the kernel sources this process
    compiled, and the digest of its parameters (`weights.param_digest`).
    A serving window that captures or compiles moves the first two."""
    from ..ops import _build
    from ..weights import param_digest
    traces = dict(engine.stats()['traces'])
    return {'traces_at_ready': traces,
            'captures_at_ready': sum(traces.values()),
            'kernel_builds_at_ready': _build.COMPILES,
            'param_digest': param_digest(engine.model)}


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog='python -m paddle_tpu_torch.serving.replica_main',
        description='one supervised InferenceEngine replica process')
    p.add_argument('--socket', required=True,
                   help='AF_UNIX socket path to serve the replica RPC on')
    p.add_argument('--model-spec', required=True,
                   help='model factory: "module:callable" or '
                        '"/path/file.py:callable"')
    p.add_argument('--model-kwargs', default='{}',
                   help='JSON kwargs for the model factory')
    p.add_argument('--engine-kwargs', default='{}',
                   help='JSON kwargs for InferenceEngine')
    p.add_argument('--device', default='cuda',
                   help='device to serve on (default cuda; a child '
                        'without a card exits 3 unless given cpu)')
    p.add_argument('--weight-store', default=None,
                   help='WeightStore directory (the weight plane)')
    p.add_argument('--weight-version', type=int, default=None,
                   help='version to load at boot (default: latest)')
    p.add_argument('--spool', default=None,
                   help='observability spool dir: starts a Shipper')
    p.add_argument('--uid', default='',
                   help='process uid for spool segments / pidfiles')
    p.add_argument('--obs-scope', default=None)
    p.add_argument('--drain-deadline-s', type=float, default=30.0)
    return p


def _load(opts, factory, model_kwargs, engine_kwargs, seconds):
    """(engine, weight store or None): the device checked, the model
    built, the store's version swapped in and every graph captured; the
    seconds of each step go into `seconds`."""
    t0 = time.perf_counter()
    import torch
    device = torch.device(opts.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'--device {opts.device}: no CUDA device '
                           f'(pass --device cpu to serve on the CPU)')
    model = factory(device=str(device), **model_kwargs)
    model.eval()
    from .engine import InferenceEngine
    engine = InferenceEngine(model, **engine_kwargs)
    seconds['model'] = time.perf_counter() - t0
    weight_store = None
    if opts.weight_store:
        from .hotswap import WeightStore
        weight_store = WeightStore(opts.weight_store)
        version = (opts.weight_version
                   if opts.weight_version is not None
                   else weight_store.latest_version())
        if version is not None:
            state = weight_store.load(int(version))
            engine.swap_weights(state, version=int(version))
            del state
    seconds['weights'] = time.perf_counter() - t0 - seconds['model']
    engine.preload_programs()
    seconds['captures'] = engine.stats()['capture_seconds']
    return engine, weight_store


def main(argv=None) -> int:
    try:
        opts = _build_parser().parse_args(argv)
        model_kwargs = json.loads(opts.model_kwargs)
        engine_kwargs = json.loads(opts.engine_kwargs)
        factory = _resolve_factory(opts.model_spec)
    except SystemExit:
        return EXIT_USAGE
    except Exception:
        traceback.print_exc()
        return EXIT_USAGE

    t0 = time.perf_counter()
    seconds: Dict[str, float] = {}
    try:
        engine, weight_store = _load(opts, factory, model_kwargs,
                                     engine_kwargs, seconds)
        marks = ready_marks(engine)
    except Exception:
        traceback.print_exc()
        return EXIT_LOAD
    print(f'replica {opts.uid}: warm in {time.perf_counter() - t0:.2f} s '
          f'(' + ', '.join(f'{k} {v:.2f} s' for k, v in seconds.items())
          + f'), {marks["captures_at_ready"]} captures, '
          f'{marks["kernel_builds_at_ready"]} kernel sources compiled',
          file=sys.stderr, flush=True)

    if opts.obs_scope:
        engine.obs_scope = opts.obs_scope

    preempt = engine.enable_graceful_drain(
        deadline_s=opts.drain_deadline_s)

    shipper = None
    if opts.spool:
        from ..observability.shipper import Shipper
        shipper = Shipper(opts.spool, interval_s=0.5,
                          uid=opts.uid or None)
        shipper.start()

    # bind LAST: a connectable socket is the readiness signal the
    # supervisor polls for, so it must imply "warm and serviceable"
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        if os.path.exists(opts.socket):
            os.unlink(opts.socket)   # stale tenant of our own path
        listener.bind(opts.socket)
        listener.listen(8)
    except OSError:
        traceback.print_exc()
        return EXIT_LOAD

    server = _ReplicaServer(engine, listener,
                            weight_store=weight_store, preempt=preempt,
                            drain_deadline_s=opts.drain_deadline_s,
                            uid=opts.uid, marks=marks)
    try:
        server.serve_forever()
    finally:
        try:
            listener.close()
            if os.path.exists(opts.socket):
                os.unlink(opts.socket)
        except OSError:
            pass
        if shipper is not None:
            shipper.stop(flush=True)
    return EXIT_CLEAN


if __name__ == '__main__':
    sys.exit(main())
