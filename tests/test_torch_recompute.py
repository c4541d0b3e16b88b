"""Selective recompute and tied word embeddings, the port against the JAX
package, on the CPU.

`use_recompute` True, 'dots' and 'dots_no_batch' (the JAX model's
`jax.checkpoint` policies; the port's are torch's selective checkpoint
contexts, `nlp/llama.py`): the loss and every gradient of the tiny GQA
Llama equal the JAX model's `jax.value_and_grad` under the same policy,
and three `TrainStep`s equal the JAX steps. The ops the port's backward
dispatches show each policy at work: 'dots_no_batch' reruns no weight
matmul (its `aten.mm` are the gradients' two per projection), 'dots' also
keeps the plain attention's two `aten.bmm` per layer, True reruns the
layer's forward.

Tied embeddings: the logits and gradients of a tied model equal the JAX
model's (the embedding's gradient sums the gather's and the head's), a
tied JAX state loads through `from_jax_state` (it has no
`lm_head.weight`), and the port's paged engine serves the tied model with
the JAX engine's greedy tokens.

Tolerances: losses rtol 1e-5 and parameters after 3 steps atol 4e-5, as
tests/test_torch_train.py; each gradient to 2e-5 of its largest element
(fp32 sums in another order; measured 2.5e-6).
"""
import collections

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
from paddle_tpu import autograd as jautograd
from paddle_tpu import programs
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.jit import functional_call, functional_state
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu.tensor import Tensor as JaxTensor
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nlp.llama import SAVED_OPS
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import InferenceEngine, SamplingParams
from paddle_tpu_torch.weights import from_jax_state

from test_torch_train import (LOSS_RTOL, PARAM_ATOL, _batches, _jax_loss,
                              _models, _torch_loss)

GRAD_REL = 2e-5
POLICIES = [True, 'dots', 'dots_no_batch']
LINEARS_PER_LAYER = 7       # q, k, v, o, gate, up, down


class OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched below autograd (the ops a
    selective checkpoint policy serves from its cache never reach a mode
    entered before the backward)."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def _jax_loss_and_grads(jm, ids):
    """The JAX model's loss and gradients as its TrainStep computes them
    (`functional_call` under `jax.value_and_grad`, where its remat policy
    applies)."""
    params, frozen, buffers = functional_state(jm)

    def loss_of(pv):
        out, _ = functional_call(jm, pv, frozen, buffers, (ids,), {})
        with jautograd.functional_scope():
            return _jax_loss(JaxTensor(out), JaxTensor(ids)).value
    loss, grads = jax.value_and_grad(loss_of)(params)
    return float(loss), {n: np.asarray(g) for n, g in grads.items()}


def _close_grads(tm, want):
    for n, p in tm.named_parameters():
        w = want[n]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max(),
                                   err_msg=n)


def _tied(seed=5, layers=2):
    paddle.seed(seed)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(
        num_key_value_heads=2, num_hidden_layers=layers,
        tie_word_embeddings=True))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = from_jax_state(state, LlamaForCausalLM(LlamaConfig.tiny(
        num_key_value_heads=2, num_hidden_layers=layers,
        tie_word_embeddings=True), device='cpu'))
    return jm, tm


@pytest.mark.parametrize('policy', POLICIES)
def test_policy_loss_and_grads_match_jax(policy):
    jm, tm = _models(policy)
    assert tm.config.use_recompute == policy
    ids = _batches(1)[0]
    want_loss, want = _jax_loss_and_grads(jm, ids)
    t = torch.from_numpy(ids)
    loss = _torch_loss(tm(t), t)
    loss.backward()
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    _close_grads(tm, want)


@pytest.mark.parametrize('policy', ['dots', 'dots_no_batch'])
def test_policy_train_steps_match_jax(policy):
    programs.get_store().clear_memory()
    jm, tm = _models(policy)
    jstep = JaxTrainStep(jm, _jax_loss, JaxAdamW(
        learning_rate=1e-3, parameters=jm.parameters()))
    tstep = TrainStep(tm, _torch_loss, AdamW(learning_rate=1e-3,
                                             parameters=tm.parameters()))
    for ids in _batches():
        want = float(jstep(ids, ids).numpy())
        np.testing.assert_allclose(float(tstep(ids, ids)), want,
                                   rtol=LOSS_RTOL)
    jsd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), jsd[name], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


def _backward_ops(policy):
    _, tm = _models(policy)
    t = torch.from_numpy(_batches(1)[0])
    loss = _torch_loss(tm(t), t)
    with OpCount() as count:
        loss.backward()
    return count.ops, tm.config.num_hidden_layers


def test_backward_ops_show_each_policy():
    """Per layer, the backward dispatches each projection's two gradient
    matmuls; a full recompute adds the layer's forward matmuls up to the
    last one the backward needs (torch stops a recompute once every saved
    tensor is back: down_proj's output is not one), which 'dots_no_batch'
    and 'dots' serve from their cache. 'dots' also keeps the plain
    attention's two bmm; 'dots_no_batch' reruns them."""
    ops = {p: _backward_ops(p) for p in POLICIES + [False]}
    layers = ops[False][1]
    grads = 2 * (LINEARS_PER_LAYER * layers + 1)     # + lm_head
    assert ops[False][0]['mm'] == grads
    assert ops['dots_no_batch'][0]['mm'] == grads
    assert ops['dots'][0]['mm'] == grads
    assert ops[True][0]['mm'] == grads + (LINEARS_PER_LAYER - 1) * layers
    assert ops['dots_no_batch'][0]['bmm'] == ops[False][0]['bmm'] \
        + 2 * layers
    assert ops['dots'][0]['bmm'] == ops[False][0]['bmm']
    assert ops[True][0]['bmm'] == ops['dots_no_batch'][0]['bmm']


def test_policy_keeps_the_matmul_ops():
    aten = torch.ops.aten
    assert SAVED_OPS['dots_no_batch'] == {aten.mm.default,
                                          aten.addmm.default}
    assert SAVED_OPS['dots'] == SAVED_OPS['dots_no_batch'] | {
        aten.bmm.default, aten.baddbmm.default}


@pytest.mark.parametrize('value', ['dots_with_batch', 'all'])
def test_unknown_policy_raises(value):
    with pytest.raises(ValueError, match='use_recompute'):
        LlamaConfig.tiny(use_recompute=value)


def test_tied_model_has_no_head_and_loads_a_tied_jax_state():
    jm, tm = _tied()
    assert tm.lm_head is None and jm.lm_head is None
    assert 'lm_head.weight' not in tm.state_dict()
    assert set(tm.state_dict()) == set(jm.state_dict())
    ids = _batches(1)[0]
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    want = jm(paddle.to_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize('policy', [False, 'dots_no_batch'])
def test_tied_loss_and_grads_match_jax(policy):
    """The embedding's gradient sums the gather's and the head's, under
    a policy too (the head is outside the checkpointed layers)."""
    jm, tm = _tied()
    jm.config.use_recompute = tm.config.use_recompute = policy
    ids = _batches(1)[0]
    want_loss, want = _jax_loss_and_grads(jm, ids)
    t = torch.from_numpy(ids)
    loss = _torch_loss(tm(t), t)
    loss.backward()
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    _close_grads(tm, want)


def test_tied_train_steps_match_jax():
    programs.get_store().clear_memory()
    jm, tm = _tied()
    jstep = JaxTrainStep(jm, _jax_loss, JaxAdamW(
        learning_rate=1e-3, parameters=jm.parameters()))
    tstep = TrainStep(tm, _torch_loss, AdamW(learning_rate=1e-3,
                                             parameters=tm.parameters()))
    for ids in _batches():
        want = float(jstep(ids, ids).numpy())
        np.testing.assert_allclose(float(tstep(ids, ids)), want,
                                   rtol=LOSS_RTOL)
    jsd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), jsd[name], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


def test_tied_model_serves_the_jax_engine_tokens():
    jm, tm = _tied(seed=11)
    jm.eval()
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 128, (s,)).tolist() for s in (3, 9, 14, 30)]
    news = [6, 9, 12, 7]
    jeng = JaxEngine(jm, num_slots=2, max_length=64, decode_block=4,
                     kv_page_size=16)
    teng = InferenceEngine(tm, num_slots=2, max_length=64, decode_block=4,
                           kv_page_size=16)
    hj = jeng.generate_many(prompts, [JaxParams(max_new_tokens=n,
                                                eos_token_id=-1)
                                      for n in news])
    ht = teng.generate_many(prompts, [SamplingParams(max_new_tokens=n,
                                                     eos_token_id=-1)
                                      for n in news])
    assert [h.tokens for h in ht] == [h.tokens for h in hj]
