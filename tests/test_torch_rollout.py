"""The rollout loop (paddle_tpu_torch.loop.RolloutLoop) against the JAX
package's, on the CPU: serve → score → train → publish → swap, two
iterations each.

Both loops start from the same tiny GQA Llama (the JAX model's weights
carried into the port by `weights.from_jax_state`), train it with AdamW
through their package's `TrainStep` and `response_lm_loss`, publish each
step with a `WeightPublisher` into their own `WeightStore`, and roll each
version across a 2-replica `Router` with a `ReplicaUpdater`. Rollouts
sample with `top_k=1`, so both pick the argmax token. The port's replicas
are in-process engines, or two replica processes (`--device cpu`) behind
`RemoteReplica`s that load every version from the store themselves.

Checked per iteration: every rollout's prompt, response, reward and
the weight version it was generated under (exact), the loss (rtol
1e-5, f32), and the iteration's record: published version, the swap's
version and outcome, the fleet version, the step count and the rewards
(exact).
"""
import os

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import programs
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.loop import RolloutLoop as JaxRolloutLoop
from paddle_tpu.loop import response_lm_loss as jax_loss
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.serving import ReplicaSet as JaxReplicaSet
from paddle_tpu.serving import ReplicaUpdater as JaxUpdater
from paddle_tpu.serving import Router as JaxRouter
from paddle_tpu.serving import WeightPublisher as JaxPublisher
from paddle_tpu.serving import WeightStore as JaxStore
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.loop import RolloutLoop, response_lm_loss
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import (Replica, ReplicaSet, ReplicaSpec,
                                      ReplicaUpdater, Router, Supervisor,
                                      WeightPublisher, WeightStore)
from paddle_tpu_torch.weights import from_jax_state
from test_torch_observability import isolated_observability

VOCAB = 128
ENGINE_KW = dict(num_slots=2, max_length=32, decode_block=2,
                 kv_page_size=16)
FACTORY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       'test_torch_fleet_factory.py') + ':tiny_llama'
LOOP_KW = dict(rollouts_per_iter=4, keep_best=2, max_new_tokens=4,
               train_passes=1, top_k=1)


@pytest.fixture(autouse=True, scope='module')
def _isolated(tmp_path_factory):
    yield from isolated_observability(tmp_path_factory)


def _prompt_fn(i):
    rng = np.random.RandomState(100 + i)
    return [rng.randint(1, VOCAB, (4,)).tolist() for _ in range(4)]


def _reward_fn(prompt, response):
    return float(np.mean([t % 3 == 0 for t in response]))


def _recording(loop):
    """Keep every iteration's rollouts as (prompt, response, reward,
    weight version)."""
    seen = []
    generate = loop.generate

    def wrapped(i):
        out = generate(i)
        seen.append([(r.prompt, r.response, r.reward, r.weight_version)
                     for r in out])
        return out
    loop.generate = wrapped
    return seen


def _jax_loop(tmp_path):
    paddle.seed(0)
    cfg = jllama.LlamaConfig.tiny(num_key_value_heads=2)
    train_model = jllama.LlamaForCausalLM(cfg)
    state = {k: np.asarray(v.numpy())
             for k, v in train_model.state_dict().items()}
    programs.get_store().clear_memory()      # the JAX step traces anew
    step = JaxTrainStep(train_model, jax_loss(VOCAB), JaxAdamW(
        learning_rate=3e-3, parameters=train_model.parameters()))
    store = JaxStore(tmp_path / 'jax_w')
    publisher = JaxPublisher(train_model, store, interval_steps=1)
    v1 = publisher.publish(step=0)
    serve_model = jllama.LlamaForCausalLM(cfg).eval()
    serve_model.set_state_dict(store.load(v1))
    router = JaxRouter(JaxReplicaSet(serve_model, 2, weight_version=v1,
                                     **ENGINE_KW))
    loop = JaxRolloutLoop(
        train_step=step, router=router, publisher=publisher,
        updater=JaxUpdater(router, store), prompt_fn=_prompt_fn,
        reward_fn=_reward_fn, **LOOP_KW)
    return loop, state, v1


def _port_loop(tmp_path, state, kind):
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    train_model = from_jax_state(state, LlamaForCausalLM(cfg, device='cpu'))
    step = TrainStep(train_model, response_lm_loss(VOCAB), AdamW(
        learning_rate=3e-3, parameters=train_model.parameters()))
    store = WeightStore(str(tmp_path / 'torch_w'))
    publisher = WeightPublisher(train_model, store, interval_steps=1)
    v1 = publisher.publish(step=0)
    sup = None
    if kind == 'inproc':
        serve_model = LlamaForCausalLM(cfg, device='cpu').eval()
        from_jax_state(store.load(v1), serve_model)
        router = Router(ReplicaSet(serve_model, 2, weight_version=v1,
                                   **ENGINE_KW))
    else:
        sup = Supervisor(str(tmp_path / 'run'), ReplicaSpec(
            FACTORY, model_kwargs={'num_key_value_heads': 2},
            engine_kwargs=ENGINE_KW, weight_store_dir=str(
                tmp_path / 'torch_w'), device='cpu'),
            spawn_timeout_s=120.0)
        router = Router([Replica(0, sup.spawn()), Replica(1, sup.spawn())])
    loop = RolloutLoop(
        train_step=step, router=router, publisher=publisher,
        updater=ReplicaUpdater(router, store), prompt_fn=_prompt_fn,
        reward_fn=_reward_fn, **LOOP_KW)
    return loop, v1, sup


@pytest.mark.parametrize('kind', ['inproc', 'procs'])
def test_rollout_loop_matches_jax(kind, tmp_path):
    jloop, state, jv1 = _jax_loop(tmp_path)
    ploop, pv1, sup = _port_loop(tmp_path, state, kind)
    try:
        seen = {'jax': _recording(jloop), 'torch': _recording(ploop)}
        hist = {'jax': jloop.run(2), 'torch': ploop.run(2)}
        served = [r.engine.stats()['weight_version']
                  for r in ploop.router.replicas]
    finally:
        if sup is not None:
            sup.stop_all(deadline_s=10.0)
    assert pv1 == jv1
    assert seen['torch'] == seen['jax']
    assert [[r[3] for r in it] for it in seen['torch']] == \
        [[pv1] * 4, [pv1 + 1] * 4]
    np.testing.assert_allclose([h['loss'] for h in hist['torch']],
                               [h['loss'] for h in hist['jax']], rtol=1e-5)
    strip = [[{k: v for k, v in h.items() if k != 'loss'} for h in hist[p]]
             for p in ('torch', 'jax')]
    assert strip[0] == strip[1]
    assert [h['swap'] for h in hist['torch']] == [
        {'version': pv1 + 1, 'outcome': 'completed'},
        {'version': pv1 + 2, 'outcome': 'completed'}]
    assert ploop.updater.fleet_version == \
        ploop.publisher.last_published_version == pv1 + 2
    assert all(np.isfinite(h['loss']) for h in hist['torch'])
    assert served == [pv1 + 2] * 2      # what each replica itself reports
