"""The fleet observability plane and the replica RPC frames
(paddle_tpu_torch.observability.wire / shipper / aggregator,
serving.remote's framing) against the JAX package's, on the CPU.

- Segments cross the packages: one segment dict encodes to the same
  bytes in both, and a segment written by either package (every kind,
  a metrics delta included) decodes under the other's
  `wire.decode_segment`; a torn payload is a `WireError` in both.
- `merge_snapshots` gives equal results on the same snapshots
  (counters, gauges, histograms and their quantiles, the goodput
  fractions recomputed, duplicated snapshots collapsed).
- Both aggregators build the same view from one spool that both
  packages' shippers wrote into: the merged doc, the per-process
  snapshots and values, the clock offsets and the stitched trace.
- The fleet signal source folds the same signals, the autoscaler and
  the SLO engine read it, and the port's server serves `/fleet/metrics`
  and `/fleet/trace` (503 without an aggregator).
- The port's copy of the 3-process skew harness (children that import
  only the port, `jax` absent from their `sys.modules`) recovers the
  injected skews, the merged counters and one skew-corrected waterfall.
- `send_msg` frames from both packages are byte-identical over a
  `socket.socketpair()`, each package's `recv_msg` reads the other's,
  and a torn or corrupted frame raises the transient errors.

Every comparison here is exact (JSON and integer data), except the
recovered skews (within 5 s of hundreds, as the JAX harness).
"""
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from paddle_tpu import observability as jobs
from paddle_tpu.observability import aggregator as jagg
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import wire as jwire
from paddle_tpu.observability.events import EventLog as JEventLog
from paddle_tpu.serving import remote as jremote
from paddle_tpu_torch import observability as pobs
from paddle_tpu_torch.observability import aggregator as pagg
from paddle_tpu_torch.observability import metrics as pmetrics
from paddle_tpu_torch.observability import slo as pslo
from paddle_tpu_torch.observability import wire as pwire
from paddle_tpu_torch.observability.events import EventLog as PEventLog
from paddle_tpu_torch.serving import remote as premote
from test_torch_observability import isolated_observability

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {'jax': (jobs, jwire, jmetrics, JEventLog),
       'torch': (pobs, pwire, pmetrics, PEventLog)}
PAIRS = [('jax', 'torch'), ('torch', 'jax')]


@pytest.fixture(autouse=True, scope='module')
def _isolated(tmp_path_factory):
    yield from isolated_observability(tmp_path_factory)


@pytest.fixture(autouse=True)
def _no_request_records():
    """Each shipper also drains its package's request ledger: finished
    requests of earlier tests must not ride into these spools."""
    for obs in (jobs, pobs):
        obs.get_request_ledger().drain_wire_records()
    yield


def _source(pkg, n=5, trace_id=77, gauge=2.5):
    """A private registry and event log of `pkg` holding known values."""
    _, _, metrics, EventLog = PKG[pkg]
    reg = metrics.MetricsRegistry(process_index=0)
    reg.counter('paddle_fleet_test_total', 'fleet-plane test counter').inc(n)
    reg.gauge('paddle_fleet_test_gauge', 'fleet-plane test gauge').set(gauge)
    h = reg.histogram('paddle_fleet_test_seconds', 'fleet-plane test hist',
                      buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 0.5, 2.0):
        h.observe(v)
    log = EventLog(capacity=256)
    log.append({'name': 'unit.work', 'ph': 'X', 'ts': 1.0, 'dur': 0.25,
                'tid': 3, 'attrs': {'request_id': trace_id}})
    log.append({'name': 'unit.mark', 'ph': 'i', 'ts': 1.5, 'tid': 3,
                'attrs': {'request_id': trace_id}})
    return reg, log


# ---------------------------------------------------------------------------
# segments across the packages
# ---------------------------------------------------------------------------

def test_one_segment_encodes_to_the_same_bytes():
    recs = [{'name': 'a', 'ts': 1.5, 'attrs': {'x': [1, 2], 'é': None}},
            {'name': 'b', 'ph': 'X', 'dur': 0.25}]
    for kind in sorted(jwire.KINDS):
        seg = jwire.make_segment(kind, recs, seq=3, uid='p1',
                                 wall_ts=100.0, mono_ts=10.0)
        assert pwire.make_segment(kind, recs, seq=3, uid='p1',
                                  wall_ts=100.0, mono_ts=10.0) == seg
        assert pwire.encode_segment(seg) == jwire.encode_segment(seg)
        assert pwire.segment_filename(seg) == jwire.segment_filename(seg)
    assert pwire.WIRE_VERSION == jwire.WIRE_VERSION
    assert pwire.KINDS == jwire.KINDS


@pytest.mark.parametrize('writer,reader', PAIRS)
def test_a_segment_written_by_one_package_decodes_under_the_other(
        writer, reader, tmp_path):
    _, wmod, _, _ = PKG[writer]
    _, rmod, _, _ = PKG[reader]
    reg, log = _source(writer)
    delta = wmod.metrics_delta(None, reg.snapshot())
    segs = [wmod.make_segment(wmod.KIND_METRICS, delta, 1, uid='w'),
            wmod.make_segment(wmod.KIND_SPANS, log.events()[:1], 2,
                              uid='w'),
            wmod.make_segment(wmod.KIND_EVENTS, log.events()[1:], 3,
                              uid='w')]
    for seg in segs:
        path = wmod.write_segment(str(tmp_path), seg)
        got = rmod.read_segment(path)
        assert got == rmod.decode_segment(wmod.encode_segment(seg))
        assert got['records'] == json.loads(json.dumps(seg['records']))
        assert {k: got[k] for k in ('v', 'kind', 'process_uid', 'seq',
                                    'n', 'sha256')} == \
            {k: seg[k] for k in ('v', 'kind', 'process_uid', 'seq', 'n',
                                 'sha256')}
    # the reader folds the writer's delta as its own
    st_r = rmod.new_state('w')
    rmod.fold_metrics_delta(st_r, rmod.read_segment(
        os.path.join(str(tmp_path), 'w', rmod.segment_filename(segs[0]))
    )['records'], 1)
    st_w = wmod.new_state('w')
    wmod.fold_metrics_delta(st_w, delta, 1)
    assert rmod.state_to_snapshot(st_r) == wmod.state_to_snapshot(st_w)


@pytest.mark.parametrize('writer,reader', PAIRS)
def test_a_torn_segment_is_a_wire_error_under_either(writer, reader):
    _, wmod, _, _ = PKG[writer]
    _, rmod, _, _ = PKG[reader]
    enc = wmod.encode_segment(wmod.make_segment(
        wmod.KIND_EVENTS, [{'name': 'a'}], 1, uid='w'))
    head, _, payload = enc.partition('\n')
    with pytest.raises(rmod.WireError, match='sha256'):
        rmod.decode_segment(head + '\n' + payload.replace('"a"', '"b"'))
    with pytest.raises(rmod.WireError, match='version'):
        rmod.decode_segment(enc.replace('"v": 1', '"v": 99', 1))


def test_metrics_deltas_and_folds_match():
    regs = {p: _source(p, n=5)[0] for p in PKG}
    snaps0 = {p: r.snapshot() for p, r in regs.items()}
    for p, r in regs.items():
        r.get('paddle_fleet_test_total').labels().inc(3)
        r.get('paddle_fleet_test_gauge').labels().set(7.0)
        r.get('paddle_fleet_test_seconds').labels().observe(0.7)
    deltas = {p: PKG[p][1].metrics_delta(snaps0[p], regs[p].snapshot())
              for p in PKG}
    assert deltas['torch'] == deltas['jax']
    # steady state ships nothing in either
    for p, r in regs.items():
        s = r.snapshot()
        assert PKG[p][1].metrics_delta(s, r.snapshot()) == []


# ---------------------------------------------------------------------------
# merge_snapshots
# ---------------------------------------------------------------------------

def _goodput_snapshot(uid, idx, secs, wall, frac):
    return {'process_uid': uid, 'process_index': idx, 'metrics': [
        {'name': 'paddle_goodput_seconds_total', 'type': 'counter',
         'help': 'h', 'samples': [
             {'labels': {'category': c}, 'value': v}
             for c, v in secs.items()]},
        {'name': 'paddle_goodput_wall_seconds_total', 'type': 'counter',
         'help': 'h', 'samples': [{'labels': {}, 'value': wall}]},
        {'name': 'paddle_goodput_fraction', 'type': 'gauge', 'help': 'h',
         'samples': [{'labels': {'category': c}, 'value': frac}
                     for c in secs]}]}


def test_merge_snapshots_matches_jax():
    snaps = []
    for i, p in enumerate(('jax', 'torch', 'jax')):
        reg = _source(p, n=i + 1, gauge=float(i))[0]
        s = reg.snapshot()
        s['process_uid'] = f'proc-{i}'
        snaps.append(s)
    snaps.append(dict(snaps[0]))          # a gathered copy: collapses
    snaps.append(_goodput_snapshot('proc-3', 0, {'serving_decode': 3.0,
                                                 'idle': 1.0}, 4.0, 0.9))
    snaps.append(_goodput_snapshot('proc-4', 1, {'serving_decode': 1.0,
                                                 'idle': 3.0}, 4.0, 0.1))
    want = jmetrics.merge_snapshots(json.loads(json.dumps(snaps)))
    got = pmetrics.merge_snapshots(json.loads(json.dumps(snaps)))
    assert got == want
    merged = {m['name']: m for m in got['metrics']}
    assert merged['paddle_fleet_test_total']['samples'][0]['value'] == 6.0
    fr = {s['labels']['category']: s['value']
          for s in merged['paddle_goodput_fraction']['samples']}
    assert fr == {'serving_decode': 0.5, 'idle': 0.5}


# ---------------------------------------------------------------------------
# one spool, both aggregators
# ---------------------------------------------------------------------------

def _mixed_spool(spool):
    """Two processes of each package ship twice into `spool`."""
    uids = []
    for i, p in enumerate(('jax', 'torch', 'torch', 'jax')):
        obs = PKG[p][0]
        reg, log = _source(p, n=10 * (i + 1), trace_id=900 + i % 2)
        uid = f'{p}-{i}'
        sh = obs.Shipper(spool, registry=reg, event_log=log, uid=uid)
        sh.ship_now()
        reg.get('paddle_fleet_test_total').labels().inc(i + 1)
        reg.get('paddle_fleet_test_gauge').labels().set(10.0 - i)
        sh.ship_now()
        uids.append(uid)
    return uids


def test_both_aggregators_build_the_same_view(tmp_path):
    spool = str(tmp_path)
    uids = _mixed_spool(spool)
    views = {}
    for p in PKG:
        agg = PKG[p][0].Aggregator(spool)
        counts = agg.poll()
        assert counts['quarantined'] == 0 and counts['applied'] > 0
        assert agg.poll() == {'applied': 0, 'duplicates': 0,
                              'quarantined': 0}
        views[p] = {
            'uids': agg.process_uids(),
            'merged': agg.merged(),
            'per_process': agg.per_process_snapshots(),
            'values': agg.per_process_value('paddle_fleet_test_total'),
            'gauges': agg.per_process_value('paddle_fleet_test_gauge',
                                            agg='max'),
            'offsets': agg.clock_offsets(),
            'trace_ids': agg.trace_ids(),
            'trace': agg.stitch_trace(),
            'trace_900': agg.stitch_trace(trace_id=900),
        }
    assert views['torch'] == views['jax']
    v = views['torch']
    assert v['uids'] == sorted(uids)
    assert v['values'] == {u: 11.0 * (i + 1) for i, u in enumerate(uids)}
    total = {m['name']: m for m in v['merged']['metrics']}[
        'paddle_fleet_test_total']['samples'][0]['value']
    assert total == sum(v['values'].values())
    assert len([e for e in v['trace_900']['traceEvents']
                if e['ph'] == 'X']) == 2


def test_a_torn_file_is_quarantined_by_the_port(tmp_path):
    spool = str(tmp_path)
    reg, log = _source('jax')
    path = jobs.Shipper(spool, registry=reg, event_log=log,
                        uid='w').ship_now()[0]
    with open(path, 'a') as f:
        f.write('{"torn": true}\n')
    agg = pobs.Aggregator(spool)
    counts = agg.poll()
    assert counts['quarantined'] == 1
    assert os.path.exists(path + pwire.QUARANTINE_SUFFIX)
    assert agg.stats()['quarantined'] == [path + pwire.QUARANTINE_SUFFIX]


# ---------------------------------------------------------------------------
# the fleet signal source, the autoscaler, the SLO engine, the server
# ---------------------------------------------------------------------------

def _ship_router_signals(pkg, spool, uid, ttft, queue, shed, serving):
    obs, _, metrics, EventLog = PKG[pkg]
    reg = metrics.MetricsRegistry(process_index=0)
    reg.gauge('paddle_ttft_p99_window', 'h').set(ttft)
    reg.gauge('paddle_queue_depth_p99_window', 'h').set(queue)
    reg.gauge('paddle_shed_rate_window', 'h').set(shed)
    reg.gauge('paddle_router_available_replicas', 'h').set(serving)
    obs.Shipper(spool, registry=reg, event_log=EventLog(capacity=4),
                uid=uid).ship_now()


def test_fleet_signal_source_folds_as_jax(tmp_path):
    spool = str(tmp_path)
    _ship_router_signals('jax', spool, 'router-a', ttft=0.9, queue=3.0,
                         shed=0.5, serving=2)
    _ship_router_signals('torch', spool, 'router-b', ttft=0.2, queue=1.0,
                         shed=0.0, serving=1)
    sigs = {p: PKG[p][0].FleetSignalSource(PKG[p][0].Aggregator(spool),
                                           fresh_s=3600.0)()
            for p in PKG}
    assert sigs['torch'] == sigs['jax']
    assert sigs['torch']['source'] == 'fleet'
    assert sigs['torch']['serving_replicas'] == 3
    now = [time.time() + 3600.0]         # every shipper an hour silent
    stale = pobs.FleetSignalSource(pobs.Aggregator(spool), fresh_s=30.0,
                                   clock=lambda: now[0])()
    assert stale['source'] == 'fleet_empty'


def test_the_autoscaler_reads_a_fleet_signal_source(tmp_path):
    from paddle_tpu_torch.serving.autoscaler import (HOLD_AT_MAX,
                                                     Autoscaler,
                                                     AutoscalerConfig)
    _ship_router_signals('torch', str(tmp_path), 'router-a', ttft=5.0,
                         queue=0.0, shed=0.0, serving=1)

    class _IdleRouter:
        replicas = [object()]

        def window_signals(self):
            return {'window_s': 1.0, 'ttft_p50': None, 'ttft_p99': None,
                    'queue_p50': 0.0, 'queue_p99': 0.0, 'shed_rate': 0.0,
                    'accept_rate': 0.0, 'serving_replicas': 1}

    router = _IdleRouter()
    cfg = AutoscalerConfig(min_replicas=1, max_replicas=1, slo_ttft_s=1.0,
                           cooldown_s=0.0)
    src = pobs.FleetSignalSource(pobs.Aggregator(str(tmp_path)),
                                 router=router, fresh_s=3600.0)
    t = [100.0]
    fleet_as = Autoscaler(router, lambda: None, config=cfg,
                          clock=lambda: t[0], force=True,
                          signal_source=src)
    local_as = Autoscaler(router, lambda: None, config=cfg,
                          clock=lambda: t[0], force=True)
    assert fleet_as.poll() == HOLD_AT_MAX      # the fleet sees the breach
    assert local_as.poll() != HOLD_AT_MAX      # the local view is idle
    assert fleet_as.stats()['signal_source'] == 'FleetSignalSource'


@pytest.mark.parametrize('kind', ['signal_source', 'merged'])
def test_the_slo_engine_reads_the_fleet_view(kind, tmp_path):
    _ship_router_signals('jax', str(tmp_path), 'router-a', ttft=5.0,
                         queue=0.0, shed=0.0, serving=1)
    agg = pobs.Aggregator(str(tmp_path))
    agg.poll()
    src = pobs.FleetSignalSource(agg, fresh_s=3600.0) \
        if kind == 'signal_source' else agg.merged
    t = [0.0]
    eng = pslo.SLOEngine(view_fn=src, clock=lambda: t[0], flight=False,
                         short_window_s=10.0, long_window_s=60.0)
    for _ in range(3):
        t[0] += 1.0
        rep = eng.poll()
    ttft = [o for o in rep['objectives'] if o['name'] == 'ttft_p99'][0]
    assert ttft['alerting'] and ttft['budget_remaining'] == 0.0


def _get(url):
    return urllib.request.urlopen(url, timeout=10).read().decode()


def test_the_port_server_serves_the_fleet_plane(tmp_path):
    spool = str(tmp_path)
    uids = _mixed_spool(spool)
    srv = pobs.start_server(0, host='127.0.0.1')
    try:
        for route in ('/fleet/metrics', '/fleet/trace'):
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(srv.url + route, timeout=10)
            assert exc.value.code == 503
        assert '/fleet/metrics /fleet/trace' in _get(srv.url + '/')
        pagg.set_aggregator(pobs.Aggregator(spool))
        body = _get(srv.url + '/fleet/metrics')
        jagg.set_aggregator(jobs.Aggregator(spool))
        jagg.get_aggregator().poll()
        assert body == jobs.fleet_to_prometheus_text(jagg.get_aggregator())
        assert 'paddle_fleet_test_total{process="fleet"} 110' in body
        for uid in uids:
            assert f'process="{uid}"' in body
        trace = json.loads(_get(srv.url + '/fleet/trace?trace_id=901'))
        assert trace == jagg.get_aggregator().stitch_trace(trace_id=901)
        assert len([e for e in trace['traceEvents']
                    if e['ph'] == 'X']) == 2
        reqs = json.loads(_get(srv.url + '/requests'))
        assert reqs['fleet'] == []
    finally:
        srv.stop()
        pagg.set_aggregator(None)
        jagg.set_aggregator(None)


# ---------------------------------------------------------------------------
# the 3-process skew harness, children importing only the port
# ---------------------------------------------------------------------------

_CHILD = r'''
import sys, time
spool, idx, skew, trace_id, base_wall = (
    sys.argv[1], int(sys.argv[2]), float(sys.argv[3]), int(sys.argv[4]),
    float(sys.argv[5]))
from paddle_tpu_torch.observability import events, metrics, shipper
events._EPOCH -= skew          # inject the skew into the span clock
reg = metrics.get_registry()
reg.counter('paddle_fleet_test_total',
            'fleet-plane test counter').inc((idx + 1) * 10)
log = events.get_event_log()
local_offset = time.time() - events._now()
role = ['router', 'prefill', 'decode'][idx % 3]
log.append({'name': role + '.work', 'ph': 'X',
            'ts': base_wall + idx * 1.0 - local_offset, 'dur': 0.5,
            'tid': 1, 'attrs': {'request_id': trace_id,
                                'role': role, 'child': idx}})
sh = shipper.Shipper(spool, uid='child-%d' % idx)
sh.ship_now()
reg.get('paddle_fleet_test_total').labels().inc(idx + 1)
sh.ship_now()
print('jax' in sys.modules, 'paddle_tpu' in sys.modules)
'''

TRACE_ID = 424242
SKEWS = [0.0, 500.0, -300.0]


@pytest.fixture(scope='module')
def fleet_spool(tmp_path_factory):
    spool = str(tmp_path_factory.mktemp('torch_fleet_spool'))
    base_wall = time.time()
    procs = [subprocess.Popen(
        [sys.executable, '-c', _CHILD, spool, str(i), str(SKEWS[i]),
         str(TRACE_ID), str(base_wall)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO)
        for i in range(3)]
    for i, p in enumerate(procs):
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, f'child {i}:\n{err.decode()[-2000:]}'
        assert out.decode().split() == ['False', 'False'], out
    return spool


@pytest.mark.parametrize('pkg', ['torch', 'jax'])
def test_merged_counters_equal_the_sum_of_truths(pkg, fleet_spool):
    agg = PKG[pkg][0].Aggregator(fleet_spool)
    assert agg.poll()['quarantined'] == 0
    assert agg.process_uids() == ['child-0', 'child-1', 'child-2']
    assert agg.per_process_value('paddle_fleet_test_total') == {
        'child-0': 11.0, 'child-1': 22.0, 'child-2': 33.0}
    total = {m['name']: m for m in agg.merged()['metrics']}[
        'paddle_fleet_test_total']['samples'][0]['value']
    assert total == 66.0


@pytest.mark.parametrize('pkg', ['torch', 'jax'])
def test_clock_skew_is_recovered_per_process(pkg, fleet_spool):
    agg = PKG[pkg][0].Aggregator(fleet_spool)
    agg.poll()
    offs = agg.clock_offsets()
    assert offs['child-0'] - offs['child-1'] == pytest.approx(500.0, abs=5)
    assert offs['child-0'] - offs['child-2'] == pytest.approx(-300.0,
                                                              abs=5)


def test_the_trace_stitches_one_skew_corrected_waterfall(fleet_spool):
    agg = pobs.Aggregator(fleet_spool)
    agg.poll()
    doc = agg.stitch_trace(trace_id=TRACE_ID)
    ref = jobs.Aggregator(fleet_spool)
    ref.poll()
    assert doc == ref.stitch_trace(trace_id=TRACE_ID)
    spans = sorted((e for e in doc['traceEvents'] if e['ph'] == 'X'),
                   key=lambda e: e['ts'])
    assert [e['name'] for e in spans] == ['router.work', 'prefill.work',
                                          'decode.work']
    assert len({e['pid'] for e in spans}) == 3
    for a, b in zip(spans, spans[1:]):
        assert b['ts'] - a['ts'] == pytest.approx(1e6, abs=0.1e6)


# ---------------------------------------------------------------------------
# the RPC frames
# ---------------------------------------------------------------------------

_MSGS = [{'method': 'step', 'args': {}},
         {'result': {'updates': {'3': {'status': 'RUNNING',
                                       'tokens': [5, 6, 7]}},
                     'progressed': 2, 'step_wall_s': 0.0123}},
         {'error': {'type': 'ValueError', 'message': 'é "quoted"',
                    'transient': False}}]


def _frames(mod, msgs):
    a, b = socket.socketpair()
    try:
        sizes = [mod.send_msg(a, m) for m in msgs]
        a.shutdown(socket.SHUT_WR)
        raw = b''
        while True:
            chunk = b.recv(65536)
            if not chunk:
                break
            raw += chunk
    finally:
        a.close()
        b.close()
    return raw, sizes


def test_send_msg_frames_are_byte_identical():
    raw_j, sizes_j = _frames(jremote, _MSGS)
    raw_p, sizes_p = _frames(premote, _MSGS)
    assert raw_p == raw_j and sizes_p == sizes_j


@pytest.mark.parametrize('sender,receiver', PAIRS)
def test_recv_msg_reads_the_other_packages_frames(sender, receiver):
    mods = {'jax': jremote, 'torch': premote}
    a, b = socket.socketpair()
    try:
        for m in _MSGS:
            mods[sender].send_msg(a, m)
            assert mods[receiver].recv_msg(b) == m
    finally:
        a.close()
        b.close()


def test_torn_and_corrupt_frames_raise_transient_errors():
    from paddle_tpu_torch.resilience import is_transient
    raw, _ = _frames(premote, _MSGS[:1])
    for data, err in ((raw[:-3], premote.IncompleteFrameError),
                      (raw[:2], premote.IncompleteFrameError),
                      (raw[:-1] + b'x', premote.FrameChecksumError)):
        a, b = socket.socketpair()
        try:
            a.sendall(data)
            a.shutdown(socket.SHUT_WR)
            with pytest.raises(err) as exc:
                premote.recv_msg(b)
            assert is_transient(exc.value)
        finally:
            a.close()
            b.close()
    assert premote.FRAME_MAX == jremote.FRAME_MAX
