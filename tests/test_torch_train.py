"""The port's training slice against the JAX package's, on the CPU.

The tiny GQA Llama (f32) gets the JAX model's weights through
`from_jax_state`; both packages then take 3 AdamW steps of their
`TrainStep` on the same batches (made from a seed with numpy), with the
JAX training headline's loss: next-token cross-entropy,
`F.cross_entropy(logits[:, :-1], labels[:, 1:])`. On the CPU every kernel
wrapper takes its plain version, so this holds the port's whole training
path (attention and its backward, RMSNorm and its gradient, the fused
cross-entropy, recompute, AdamW) to the JAX package's.

Tolerances: losses agree to rtol 1e-5 (fp32 sums in another order in
each framework); parameters after 3 steps to atol 4e-5 at lr 1e-3. An
Adam step moves an element by about lr * m / sqrt(v), which for an
element whose gradient is near 0 magnifies an fp32 difference in that
gradient, so the parameters are compared by absolute error at a small
fraction of the learning rate (measured: 1.2e-5 at most).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import programs
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.nn import clip as jclip
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.weights import from_jax_state

LR = 1e-3
LOSS_RTOL = 1e-5
PARAM_ATOL = 4e-5


def _models(use_recompute, seed=7, layers=2):
    paddle.seed(seed)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(
        num_key_value_heads=2, num_hidden_layers=layers,
        use_recompute=use_recompute))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = from_jax_state(state, LlamaForCausalLM(
        LlamaConfig.tiny(num_key_value_heads=2, num_hidden_layers=layers,
                         use_recompute=use_recompute), device='cpu'))
    return jm, tm


def _batches(n=3, shape=(2, 24), seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, shape) for _ in range(n)]


def _jax_loss(logits, labels):
    return JF.cross_entropy(logits[:, :-1].reshape([-1, 128]),
                            labels[:, 1:].reshape([-1]))


def _torch_loss(logits, labels):
    return F.cross_entropy(logits[:, :-1].reshape(-1, 128),
                           labels[:, 1:].reshape(-1))


@pytest.mark.parametrize('use_recompute', [False, True])
def test_train_step_matches_jax(use_recompute):
    jm, tm = _models(use_recompute)
    jstep = JaxTrainStep(jm, _jax_loss, JaxAdamW(
        learning_rate=LR, parameters=jm.parameters()))
    tstep = TrainStep(tm, _torch_loss, AdamW(learning_rate=LR,
                                             parameters=tm.parameters()))
    for ids in _batches():
        want = float(jstep(ids, ids).numpy())
        got = tstep(ids, ids)
        assert got.requires_grad is False and got.device.type == 'cpu'
        np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)
    jsd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), jsd[name], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
        assert tm.get_parameter(name).grad is None


def _pretraining_optimizer(lr_mod, clip_mod, opt_cls, params, clip_norm):
    """Llama 2's pretraining optimizer (chip_smoke.py phase 5b), at a
    warm-up and cosine short enough for 3 steps: AdamW(0.9, 0.95, 1e-5),
    decay 0.1 except on norms, a global-norm clip."""
    sched = lr_mod.LinearWarmup(
        lr_mod.CosineAnnealingDecay(LR, T_max=10, eta_min=LR / 10),
        warmup_steps=2, start_lr=LR / 4, end_lr=LR)
    return sched, opt_cls(
        learning_rate=sched, beta1=0.9, beta2=0.95, epsilon=1e-5,
        weight_decay=0.1, apply_decay_param_fun=lambda n: 'norm' not in n,
        grad_clip=clip_mod.ClipGradByGlobalNorm(clip_norm),
        parameters=params)


@pytest.mark.parametrize('clip_norm', [0.5, 1.0])
def test_train_step_pretraining_recipe_matches_jax(clip_norm):
    """3 steps of both TrainSteps under the clip, the scheduler (stepped
    by the caller after each step, read by each step) and the decay
    exemption. The first batch's grads have a global norm of ~4.0, so
    both limits clip."""
    jm, tm = _models(False)
    # the JAX program store keys a TrainStep's program by the optimizer's
    # public scalar attributes, and an optimizer's hyperparameters are all
    # private: without this, the JAX step would reuse the program traced
    # for an earlier AdamW of other betas, epsilon, decay and clip
    programs.get_store().clear_memory()
    jsched, jopt = _pretraining_optimizer(jlr, jclip, JaxAdamW,
                                          jm.parameters(), clip_norm)
    tsched, topt = _pretraining_optimizer(tlr, tnn, AdamW,
                                          tm.parameters(), clip_norm)
    jstep = JaxTrainStep(jm, _jax_loss, jopt)
    tstep = TrainStep(tm, _torch_loss, topt)
    lrs = []
    for ids in _batches():
        lrs.append(topt.get_lr())
        want = float(jstep(ids, ids).numpy())
        np.testing.assert_allclose(float(tstep(ids, ids)), want,
                                   rtol=LOSS_RTOL)
        jsched.step()
        tsched.step()
    assert lrs == [LR / 4, LR / 4 + (LR - LR / 4) / 2, LR]
    jsd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), jsd[name], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


def test_recompute_gives_the_same_gradients():
    """use_recompute re-runs each decoder layer in the backward; the
    gradients are those of the plain backward."""
    grads = []
    ids = torch.from_numpy(_batches(1)[0])
    for remat in (False, True):
        _, tm = _models(remat)
        loss, _ = tm(ids, labels=ids)
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in tm.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0, atol=0)


def test_labels_forward_matches_jax():
    jm, tm = _models(False)
    ids = _batches(1)[0]
    jloss, jlogits = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
    loss, logits = tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(logits.detach().numpy(), jlogits.numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize('policy', ['dots', 'dots_no_batch'])
def test_selective_recompute_policies_are_not_ported(policy):
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        LlamaConfig.tiny(use_recompute=policy)


def test_train_step_takes_numpy_and_tensor_inputs():
    _, tm = _models(True, layers=1)
    step = TrainStep(tm, _torch_loss, AdamW(learning_rate=1e-2,
                                            parameters=tm.parameters()))
    ids = _batches(1)[0]
    first = float(step(ids, ids))
    for _ in range(3):
        last = float(step(torch.from_numpy(ids), torch.from_numpy(ids)))
    assert np.isfinite(first) and last < first


def test_train_step_rejects_a_frozen_layer():
    _, tm = _models(False, layers=1)
    tm.requires_grad_(False)
    with pytest.raises(ValueError):
        TrainStep(tm, _torch_loss, AdamW(parameters=tm.parameters()))
