"""`device`, `version`, `sysconfig`, the top-level shims, `Generator`
and `profiler` of the port against the JAX package's, on the CPU.

Where the two packages' answers rightly differ (the port runs on a CUDA
build of PyTorch, the JAX package on XLA), the port is held to PyTorch's
own figures: `device_count` to `torch.cuda.device_count()`, the memory
functions to `torch.cuda`'s (0 on this CPU build), `empty_cache` to
upstream's meaning (ROADMAP: differences that are not faults). The
profiler's schedulers, windows, handlers and exported host regions are
held to the JAX profiler's on the same driving loop.
"""
import json
import os

import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu import profiler as JP
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch import profiler as TP


# -- device -----------------------------------------------------------------

def test_device_functions_are_pytorchs():
    d = ptt.device
    assert d.device_count() == d.cuda.device_count() == \
        torch.cuda.device_count()
    for name in ('memory_allocated', 'max_memory_allocated',
                 'memory_reserved', 'max_memory_reserved'):
        assert getattr(d, name)() == getattr(torch.cuda, name)()
        assert getattr(d.cuda, name) is getattr(d, name)
    d.cuda.empty_cache()          # a no-op without a card
    assert set(paddle.device.__all__) <= set(dir(d))
    assert set(paddle.device.cuda.__all__) <= set(dir(d.cuda))
    assert d.get_device() == ptt.get_device()


def test_version_and_sysconfig():
    v = ptt.version
    assert v.full_version == paddle.version.full_version == ptt.__version__
    assert v.cuda() == (torch.version.cuda or 'False')
    assert v.cudnn() == v.cudnn_version
    assert ptt.sysconfig.get_include().endswith(
        os.path.join('paddle_tpu_torch', 'csrc'))
    assert os.path.isdir(ptt.sysconfig.get_include())
    assert ptt.sysconfig.get_lib().endswith(
        os.path.join('build', 'paddle_tpu_torch'))


def test_version_show_says_which_build(capsys):
    ptt.version.show()
    out = capsys.readouterr().out
    assert 'full_version: 0.1.0' in out and 'cuda:' in out


def test_top_level_shims():
    assert ptt.is_compiled_with_cuda() == (torch.version.cuda is not None)
    for name in ('is_compiled_with_rocm', 'is_compiled_with_xpu',
                 'is_compiled_with_custom_device'):
        assert getattr(ptt, name)() is getattr(paddle, name)() is False
    want = (torch.backends.cudnn.version()
            if torch.backends.cudnn.is_available() else None)
    assert ptt.get_cudnn_version() == want
    assert ptt.in_dynamic_mode() and paddle.in_dynamic_mode()
    ptt.enable_static()
    assert not ptt.in_dynamic_mode()
    ptt.disable_static()
    assert ptt.in_dynamic_mode()
    assert ptt.L2Decay is ptt.regularizer.L2Decay
    assert ptt.L1Decay(0.1)._coeff == paddle.L1Decay(0.1)._coeff


def test_generator_seed_and_state():
    g = ptt.Generator(5)
    st = g.state()
    a = torch.rand(4, generator=g.generator)
    b = torch.rand(4, generator=g.generator)
    g.set_state(st)
    assert torch.equal(torch.rand(4, generator=g.generator), a)
    assert g.state()['seed'] == 5
    assert g.manual_seed(5) is g
    assert torch.equal(torch.rand(4, generator=g.generator), a)
    assert not torch.equal(a, b)
    # the JAX Generator keeps the same surface
    jg = paddle.Generator(5)
    assert jg.state()['seed'] == g.state()['seed']
    assert ptt.framework.get_cuda_rng_state() == (
        torch.cuda.get_rng_state_all() if torch.cuda.is_available() else [])
    ptt.framework.set_cuda_rng_state([])


# -- profiler ---------------------------------------------------------------

def test_make_scheduler_matches_jax():
    for kw in (dict(closed=2, ready=1, record=3, repeat=1, skip_first=1),
               dict(closed=1, ready=0, record=1),
               dict(closed=0, ready=0, record=2, repeat=2)):
        js, ts = JP.make_scheduler(**kw), TP.make_scheduler(**kw)
        assert [ts(i) for i in range(40)] == [js(i) for i in range(40)]
    with pytest.raises(ValueError):
        TP.make_scheduler(closed=0, ready=0, record=0)
    assert (TP.ProfilerState.RECORD_AND_RETURN
            == JP.ProfilerState.RECORD_AND_RETURN)
    assert TP.ProfilerTarget.GPU == JP.ProfilerTarget.GPU


def _drive(P, tmp, scheduler, steps):
    """Run `steps` steps with two regions a step under `scheduler`;
    returns ([each window's (region, calls) events], the profiler)."""
    handler = P.export_chrome_tracing(str(tmp))
    fired = []
    prof = P.Profiler(scheduler=scheduler,
                      on_trace_ready=lambda p: fired.append(handler(p)))
    prof.start()
    for _ in range(steps):
        with P.RecordEvent('work'):
            sum(range(50))
        with P.RecordEvent('other'):
            pass
        prof.step()
    prof.stop()
    return [sorted((e['name'], e['args']['calls'])
                   for e in P.load_profiler_result(f)['traceEvents'])
            for f in fired], prof


@pytest.mark.parametrize('sched', [
    'windowed', 'repeat', 'tuple', 'first'])
def test_profiler_windows_match_jax(tmp_path, sched):
    """The same scheduler (a function or a (start, end) tuple) on the same
    loop: the handler fires as often, and each window exports the same
    regions with the same call counts."""
    make = {
        'windowed': lambda P: P.make_scheduler(closed=2, ready=1, record=3,
                                               repeat=1, skip_first=1),
        'repeat': lambda P: P.make_scheduler(closed=2, ready=0, record=1),
        'tuple': lambda P: (2, 4),
        'first': lambda P: P.make_scheduler(closed=0, ready=0, record=1,
                                            repeat=1)}[sched]
    jw, _ = _drive(JP, tmp_path / 'jax', make(JP), 10)
    tw, prof = _drive(TP, tmp_path / 'torch', make(TP), 10)
    assert tw == jw and tw
    assert prof.dispatch_stats() == {'hits': 0, 'misses': 0, 'retraces': 0,
                                     'fallbacks': 0, 'calls': 0}
    with pytest.raises(ValueError):
        TP.Profiler(scheduler=(5, 3))


def test_profiler_summary_and_export(tmp_path):
    """summary() and export() over a profile: the regions, their calls
    and the step times, as the JAX profiler reports them."""
    outs = []
    for P in (JP, TP):
        with P.profile(timer_only=True) as prof:
            for _ in range(3):
                with P.RecordEvent('region'):
                    sum(range(100))
                with P.annotate('inner'):
                    pass
                prof.step()
        path = tmp_path / f'{P.__name__}.json'
        prof.export(str(path))
        outs.append((prof.summary(), json.loads(path.read_text())))
    (js, jx), (ts, tx) = outs
    assert {k: v['calls'] for k, v in tx['regions'].items()} == \
        {k: v['calls'] for k, v in jx['regions'].items()} == \
        {'region': 3, 'inner': 3}
    assert len(tx['step_times']) == len(jx['step_times']) == 3
    assert tx['dispatch'] == dict.fromkeys(tx['dispatch'], 0)
    for line in ('region', 'inner', 'steps: 3'):
        assert line in ts and line in js


def test_record_event_feeds_observability_and_torch_profiler(tmp_path):
    """A region lands in the port's observability event log (as a span)
    and, as a record_function, in a torch.profiler device trace that
    `Profiler(trace_dir=)` writes as a Chrome trace at stop()."""
    was = tobs.enabled()
    tobs.enable()
    try:
        with TP.Profiler(trace_dir=str(tmp_path)) as prof:
            with TP.RecordEvent('my_region'):
                torch.ones(8).sum()
            prof.step()
        assert prof.trace_path and os.path.isfile(prof.trace_path)
        names = {e.get('name') for e in json.loads(
            open(prof.trace_path).read())['traceEvents']}
        assert 'my_region' in names
        spans = [e for e in tobs.get_event_log().events()
                 if e.get('name') == 'my_region']
        assert spans
    finally:
        tobs.enable(was)


def test_timer_only_writes_no_device_trace(tmp_path):
    with TP.Profiler(trace_dir=str(tmp_path), timer_only=True) as prof:
        with TP.RecordEvent('r'):
            pass
    assert prof.trace_path is None
    assert not list(tmp_path.iterdir())
