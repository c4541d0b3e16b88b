"""Graceful drain, eviction and weight swaps in the port's engine against
the JAX paged engine's, on the CPU, over the tiny GQA Llama carried from
JAX by `from_jax_state`.

- `TestGracefulDrain` of tests/test_serving.py and its chunked case
  (`test_chunked_drain_finishes_mid_prefill_requests`): a preemption
  flag with requests queued and in flight finishes every accepted
  request with the JAX engine's tokens and refuses new ones with the
  same error; a drain past its deadline fails the stragglers with a
  TimeoutError and frees every slot and page; `step()` picks the flag
  up; `drain()` works without a handler and finishes a request parked
  mid-prefill; the port's copy of the preemption handler flags, escalates
  a second SIGINT and installs only on the main thread.
- `evict_all` hands every accepted request back untouched, frees every
  page, and leaves the engine serving, as the JAX engine's does.
- `TestEngineSwap` of tests/test_hotswap.py: a swap needs a drained
  engine; a shape mismatch or a missing parameter refuses the swap
  whole, with the JAX engine's error types; after a swap the tokens equal
  a fresh engine's on the new weights and the JAX engine's after the
  same swap, and a restore gives the old tokens bit for bit, with the
  parameters' storage unchanged and nothing built again; handles are
  stamped with their admission version; the prefix cache's entries are
  shadowed by a swap and serve again after the restore, as in JAX; under
  int8 KV the same.
"""
import signal
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import observability as obs
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.resilience import PreemptionHandler as JaxHandler
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.resilience import PreemptionHandler
from paddle_tpu_torch.serving import (FAILED, FINISHED, RUNNING,
                                      InferenceEngine, SamplingParams)
from paddle_tpu_torch.weights import from_jax_state
from test_torch_observability import isolated_observability

NO_EOS = -1


@pytest.fixture(autouse=True, scope='module')
def _isolated_observability(tmp_path_factory):
    """A failed request's flight bundle goes to a temp directory, and
    both packages' observability state is reset around this module."""
    yield from isolated_observability(tmp_path_factory)


@pytest.fixture(autouse=True, scope='module')
def _reset_jax_metrics():
    yield
    jax_metrics.get_registry().reset()


@pytest.fixture(autouse=True)
def _clear_draining():
    """A JAX engine's drain marks the process degraded ('draining');
    clear it after each test, as tests/test_serving.py does."""
    yield
    obs.clear_degraded('draining')


def _state(seed):
    paddle.seed(seed)
    jm = jllama.LlamaForCausalLM(
        jllama.LlamaConfig.tiny(num_key_value_heads=2)).eval()
    return jm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _port(state):
    return from_jax_state(state, LlamaForCausalLM(
        LlamaConfig.tiny(num_key_value_heads=2), device='cpu'))


@pytest.fixture(scope='module')
def models():
    jm, state = _state(11)
    return jm, _port(state)


@pytest.fixture(scope='module')
def trained_state():
    """A second, distinguishable set of weights for the same config."""
    return _state(1234)[1]


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, (s,)).tolist() for s in lens]


def _engines(models, own=False, **kw):
    """A JAX and a port engine; `own` gives the port engine a model of its
    own (a swap copies into the model's parameters in place)."""
    jm, tm = models
    if own:
        tm = _port({k: np.asarray(v.numpy())
                    for k, v in jm.state_dict().items()})
    kw = {'num_slots': 2, 'max_length': 64, 'decode_block': 2,
          'kv_page_size': 16, **kw}
    return JaxEngine(jm, **kw), InferenceEngine(tm, **kw)


def _sp(cls, n):
    return cls(max_new_tokens=n, eos_token_id=NO_EOS)


def _submit_both(jeng, eng, prompts, n):
    return ([jeng.submit(p, _sp(JaxParams, n)) for p in prompts],
            [eng.submit(p, _sp(SamplingParams, n)) for p in prompts])


def _all_pages_free(pool):
    return pool.free_page_count == pool.num_pages - 1


# ---------------------------------------------------------------------------
# graceful drain
# ---------------------------------------------------------------------------

def test_no_accepted_request_dropped_on_preemption(models):
    """The flag lands with two requests in flight and two queued: every
    accepted request finishes with the JAX engine's tokens, a new one is
    refused with the JAX engine's error and not counted."""
    jeng, eng = _engines(models)
    prompts = _prompts([3, 9, 5, 7], seed=2)
    handlers = [JaxHandler(), PreemptionHandler()]   # not installed
    errors = []
    hj, ht = _submit_both(jeng, eng, prompts, 6)
    for e, handler, hs, cls in zip((jeng, eng), handlers, (hj, ht),
                                   (JaxParams, SamplingParams)):
        e.enable_graceful_drain(handler=handler, deadline_s=120.0)
        e.step()
        assert e.scheduler.queue_depth == 2
        handler.request()
        assert e.drain()
        assert all(h.status == FINISHED for h in hs)
        with pytest.raises(RuntimeError, match='draining') as exc:
            e.submit(_prompts([4], seed=9)[0], _sp(cls, 3))
        errors.append(str(exc.value))
        assert e.stats()['submitted'] == 4 and e.draining
    assert errors[0] == errors[1]
    assert [h.tokens for h in ht] == [h.tokens for h in hj]
    assert _all_pages_free(eng.pool)


@pytest.mark.parametrize('chunked', [False, True])
def test_drain_finishes_with_the_jax_tokens(models, chunked):
    """Without a handler `drain()` is explicit; with chunked prefill a
    request parked mid-prefill finishes too."""
    kw = dict(prefill_chunk_tokens=8) if chunked else {}
    jeng, eng = _engines(models, **kw)
    prompts = _prompts([28, 4] if chunked else [4, 6], seed=37)
    hj, ht = _submit_both(jeng, eng, prompts, 3)
    for e in (jeng, eng):
        e.step()
    if chunked:
        assert not ht[0].tokens and ht[0].status == RUNNING
    assert jeng.drain(deadline_s=120.0) and eng.drain(deadline_s=120.0)
    assert [h.tokens for h in ht] == [h.tokens for h in hj]
    assert all(h.status == FINISHED for h in ht)
    assert _all_pages_free(eng.pool)


def test_drain_deadline_fails_stragglers_not_silently(models):
    jeng, eng = _engines(models)
    hj, ht = _submit_both(jeng, eng, _prompts([3, 5, 7], seed=4), 30)
    for e in (jeng, eng):
        e.step()
    assert not jeng.drain(deadline_s=0.0)
    assert not eng.drain(deadline_s=0.0)     # expires at once
    assert not eng.has_work
    for a, b in zip(hj, ht):
        assert a.status == b.status == FAILED
        assert isinstance(b.error, TimeoutError)
        assert str(b.error) == str(a.error)
    assert eng.pool.free_count == eng.pool.num_slots
    assert _all_pages_free(eng.pool)
    assert eng.stats()['failed'] == jeng.stats()['failed'] == 3


def test_step_picks_up_preemption_flag(models):
    _, tm = models
    eng = InferenceEngine(tm, num_slots=2, max_length=64, decode_block=2,
                          kv_page_size=16)
    handler = PreemptionHandler()
    assert eng.enable_graceful_drain(handler=handler,
                                     deadline_s=60.0) is handler
    h = eng.submit(_prompts([3], seed=6)[0], _sp(SamplingParams, 4))
    handler.request()
    assert not eng.draining
    eng.run()                         # step() notices the flag
    assert eng.draining and h.status == FINISHED
    eng2 = InferenceEngine(tm, num_slots=2, max_length=64, kv_page_size=16)
    eng2.begin_drain()
    with pytest.raises(RuntimeError, match='draining'):
        eng2.submit([1, 2, 3])


def test_preemption_handler_copy_behaves_like_jax():
    """The port's copy flags on request, escalates a second SIGINT, resets,
    and installs (and restores the previous handlers) on the main thread
    only."""
    for cls in (JaxHandler, PreemptionHandler):
        seen = []
        h = cls(callback=seen.append)
        assert not h.requested and h.signum is None
        h.request(signal.SIGINT)
        assert h.requested and h.signum == signal.SIGINT and seen == [2]
        with pytest.raises(KeyboardInterrupt):
            h.request(signal.SIGINT)
        h.reset()
        assert not h.requested
        prev = signal.getsignal(signal.SIGTERM)
        with cls(signals=(signal.SIGTERM,)) as inst:
            assert signal.getsignal(signal.SIGTERM) == inst._handle
        assert signal.getsignal(signal.SIGTERM) == prev
        off = cls(signals=(signal.SIGTERM,))
        t = threading.Thread(target=off.install)
        t.start()
        t.join()
        assert not off._installed


# ---------------------------------------------------------------------------
# eviction
# ---------------------------------------------------------------------------

def test_evict_all_hands_back_every_request_and_frees_every_page(models):
    jeng, eng = _engines(models, num_slots=2, prefill_chunk_tokens=8)
    prompts = _prompts([4, 20, 6, 9], seed=8)
    hj, ht = _submit_both(jeng, eng, prompts, 6)
    for e in (jeng, eng):
        e.step()
    out_j, out_t = jeng.evict_all(), eng.evict_all()
    assert [h.request_id - ht[0].request_id for h in out_t] == \
        [h.request_id - hj[0].request_id for h in out_j]
    assert sorted(h.prompt_tokens for h in out_t) == sorted(prompts)
    assert all(h.status in ('QUEUED', RUNNING) for h in out_t)
    assert not eng.has_work and eng.pool.free_count == 2
    assert _all_pages_free(eng.pool)
    # the engine keeps serving: a resubmitted orphan gets its tokens
    again = [eng.submit(h.prompt_tokens, _sp(SamplingParams, 6))
             for h in out_t]
    eng.run()
    fresh = InferenceEngine(models[1], num_slots=2, max_length=64,
                            decode_block=2, kv_page_size=16).generate_many(
        [h.prompt_tokens for h in out_t], _sp(SamplingParams, 6))
    assert [h.tokens for h in again] == [h.tokens for h in fresh]


# ---------------------------------------------------------------------------
# weight swaps (tests/test_hotswap.py::TestEngineSwap)
# ---------------------------------------------------------------------------

def _results(eng, prompts, n=6, cls=SamplingParams):
    return [eng.submit(p, _sp(cls, n)).result() for p in prompts]


def test_swap_requires_drained_engine(models, trained_state):
    jeng, eng = _engines(models, own=True)
    msgs = []
    for e, cls in ((jeng, JaxParams), (eng, SamplingParams)):
        e.submit(_prompts([5])[0], _sp(cls, 4))
        with pytest.raises(RuntimeError, match='drained') as exc:
            e.swap_weights(trained_state, version=1)
        msgs.append(str(exc.value))
        e.run()                       # draining it makes the swap legal
        e.swap_weights(trained_state, version=1)
        assert e.weight_version == 1
        with pytest.raises(RuntimeError, match='drained'):
            e.submit(_prompts([5])[0], _sp(cls, 4))
            e.restore_weights(None)
    assert msgs[0] == msgs[1]


def test_shape_mismatch_and_missing_param_refuse_the_swap(models,
                                                          trained_state):
    jeng, eng = _engines(models, own=True)
    before = {n: t.clone() for n, t in eng.model.state_dict().items()}
    name = 'llama.layers.1.mlp.down_proj.weight'
    bad = dict(trained_state)
    bad[name] = np.zeros((3, 3), np.float32)
    missing = dict(trained_state)
    missing.pop(name)
    for e in (jeng, eng):
        with pytest.raises(ValueError, match='shape'):
            e.swap_weights(bad, version=1)
        with pytest.raises(KeyError, match='missing parameter'):
            e.swap_weights(missing, version=1)
        assert e.weight_version == 0        # both refused whole
    for n, t in eng.model.state_dict().items():
        assert torch.equal(t, before[n]), n


@pytest.mark.parametrize('kv_quant', [None, 'int8'])
def test_swap_and_restore_bit_exact_nothing_built(models, trained_state,
                                                  kv_quant):
    """After a swap the tokens equal a fresh engine's on the new weights
    and the JAX engine's after the same swap; the restore gives the old
    tokens bit for bit; the parameters keep their storage and nothing is
    built or captured again."""
    jeng, eng = _engines(models, own=True, kv_quant=kv_quant)
    prompts = _prompts([5, 9], seed=3)
    before = _results(eng, prompts)
    assert before == _results(jeng, prompts, cls=JaxParams)
    steps = dict(eng._prefill_steps)
    decode, traces = eng._decode, dict(eng.stats()['traces'])
    ptrs = {n: t.data_ptr() for n, t in eng.model.named_parameters()}
    prev = eng.swap_weights(trained_state, version=1)
    jprev = jeng.swap_weights(trained_state, version=1)
    after = _results(eng, prompts)
    assert after != before                  # the weights moved
    assert after == _results(jeng, prompts, cls=JaxParams)
    fresh = InferenceEngine(_port(trained_state), num_slots=2,
                            max_length=64, decode_block=2, kv_page_size=16,
                            kv_quant=kv_quant)
    assert after == _results(fresh, prompts)
    eng.restore_weights(prev)
    jeng.restore_weights(jprev)
    assert eng.weight_version == 0
    assert _results(eng, prompts) == before
    assert all(t.device.type == 'cpu' for t in prev[0].values())
    assert {n: t.data_ptr() for n, t in eng.model.named_parameters()} == ptrs
    assert eng._prefill_steps == steps and eng._decode is decode
    assert eng.stats()['traces'] == traces
    assert eng.stats()['weight_version'] == 0


def test_handles_stamped_with_admission_version(models, trained_state):
    eng = InferenceEngine(_port(_state(11)[1]), num_slots=2, max_length=64,
                          decode_block=2, weight_version=41, kv_page_size=16)
    h1 = eng.submit(_prompts([5])[0], _sp(SamplingParams, 4))
    assert h1.weight_version is None        # queued: not admitted yet
    h1.result()
    assert h1.weight_version == 41
    eng.swap_weights(trained_state, version=42)
    h2 = eng.submit(_prompts([5])[0], _sp(SamplingParams, 4))
    h2.result()
    assert h2.weight_version == 42 and h1.weight_version == 41
    assert eng.stats()['weight_version'] == 42


def test_prefix_entries_shadowed_by_a_swap_serve_after_restore(
        models, trained_state):
    """The cache keeps entries under the version that made them: after a
    swap a prompt cached before it misses, and after the restore it hits
    again; the counters equal the JAX engine's."""
    jeng, eng = _engines(models, own=True, num_slots=4, prefix_cache=0.9)
    a, b = _prompts([40, 36], seed=12)
    stats = []
    for e, cls in ((jeng, JaxParams), (eng, SamplingParams)):
        _results(e, [a], 3, cls)
        prev = e.swap_weights(trained_state, version=1)
        _results(e, [b], 3, cls)
        e.restore_weights(prev)
        _results(e, [a], 3, cls)
        stats.append(e.stats()['prefix_cache'])
    for key in ('hits', 'misses', 'tokens_reused', 'stale_evictions'):
        assert stats[0][key] == stats[1][key], key
    assert stats[1]['hits'] == 1 and stats[1]['weight_version'] == 0
