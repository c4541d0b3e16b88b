"""The port's BERT and ERNIE (paddle_tpu_torch/nlp/bert.py, ernie.py)
against the JAX package's, on the CPU: the same weights (carried by
`from_jax_state`) and inputs (made from a seed with numpy). `state_dict`
keys and shapes, masked-LM logits and loss (pad mask, token types, ERNIE
task types), the classification loss and every gradient, and the port's
`use_recompute`, which must give the gradients of the plain backward,
with hidden dropout on too.

Tolerance: the classification loss 1e-6 relative in f32 (the JAX package
sends its V = 2 loss to XLA, the port through the CE kernels' plain
version); logits 1e-5 relative to their scale; gradients 1e-4 relative
(1e-5 absolute: fp32 sums in another order over a backward)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu.nlp import bert as jbert
from paddle_tpu.nlp import ernie as jernie
from paddle_tpu_torch import nlp
from paddle_tpu_torch.weights import from_jax_state

KINDS = {
    'bert_mlm': (jbert.BertForMaskedLM, jbert.BertConfig,
                 nlp.BertForMaskedLM, nlp.BertConfig),
    'bert_cls': (jbert.BertForSequenceClassification, jbert.BertConfig,
                 nlp.BertForSequenceClassification, nlp.BertConfig),
    'ernie_mlm': (jernie.ErnieForMaskedLM, jernie.ErnieConfig,
                  nlp.ErnieForMaskedLM, nlp.ErnieConfig),
    'ernie_cls': (jernie.ErnieForSequenceClassification, jernie.ErnieConfig,
                  nlp.ErnieForSequenceClassification, nlp.ErnieConfig),
}


def pair(kind, seed=3, **cfg):
    jcls, jcfg, tcls, tcfg = KINDS[kind]
    paddle.seed(seed)
    jm = jcls(jcfg.tiny(**cfg)).eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = from_jax_state(state, tcls(tcfg.tiny(**cfg), device='cpu')).eval()
    return jm, tm


def _inputs(seed=0, b=2, s=10):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 128, (b, s))
    types = rng.integers(0, 2, (b, s))
    mask = np.ones((b, s), np.int64)
    mask[1, -3:] = 0
    return ids, types, mask


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize('kind', sorted(KINDS))
def test_state_dict_keys_and_shapes_match_jax(kind):
    jm, tm = pair(kind)
    assert {k: tuple(v.shape) for k, v in jm.state_dict().items()} == {
        k: tuple(v.shape) for k, v in tm.state_dict().items()}


@pytest.mark.parametrize('kind', sorted(KINDS))
@pytest.mark.parametrize('masked', [False, True])
def test_outputs_match_jax(kind, masked):
    """Logits with token types (and ERNIE task types), unmasked (the
    flash path on the card) and with a 2-D pad mask (plain attention)."""
    jm, tm = pair(kind)
    ids, types, mask = _inputs(seed=len(kind))
    kw = {'token_type_ids': types}
    if masked:
        kw['attention_mask'] = mask
    if kind.startswith('ernie'):
        kw['task_type_ids'] = np.full_like(ids, 2)
    want = jm(paddle.to_tensor(ids), **{k: paddle.to_tensor(v)
                                        for k, v in kw.items()})
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), **{k: torch.from_numpy(v)
                                           for k, v in kw.items()})
    _close(got.numpy(), np.asarray(want.numpy()))


@pytest.mark.parametrize('kind', ['bert_cls', 'ernie_cls', 'bert_mlm'])
def test_loss_and_gradients_match_jax(kind):
    jm, tm = pair(kind, seed=4)
    ids, types, mask = _inputs(seed=7)
    rng = np.random.default_rng(8)
    if kind.endswith('cls'):
        labels = rng.integers(0, 2, (2,))
    else:
        labels = np.where(rng.random(ids.shape) < 0.3, ids, -100)
    jloss, _ = jm(paddle.to_tensor(ids),
                  token_type_ids=paddle.to_tensor(types),
                  attention_mask=paddle.to_tensor(mask),
                  labels=paddle.to_tensor(labels))
    jloss.backward()
    tloss, _ = tm(torch.from_numpy(ids), token_type_ids=torch.from_numpy(
        types), attention_mask=torch.from_numpy(mask),
        labels=torch.from_numpy(labels))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()),
                               float(jloss.numpy()), rtol=1e-6)
    jgrads = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        jg = jgrads[name].grad
        if jg is None:            # a pooler the loss never reaches
            assert p.grad is None or not p.grad.any()
            continue
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg.numpy()),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def _grads(model, ids, labels, seed):
    ptt.seed(seed)
    model.zero_grad()
    loss, _ = model(ids, labels=labels)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone()
                                  for n, p in model.named_parameters()}


@pytest.mark.parametrize('dropout', [0.0, 0.2])
def test_recompute_gives_the_plain_gradients(dropout):
    """`use_recompute` reruns each encoder layer in the backward; its
    rerun draws the forward's dropout masks, so the loss and every
    gradient equal the plain backward's bit for bit in f32."""
    cfg = dict(hidden_dropout_prob=dropout)
    plain = nlp.BertForSequenceClassification(
        nlp.BertConfig.tiny(**cfg), device='cpu',
        generator=torch.Generator().manual_seed(0)).train()
    remat = nlp.BertForSequenceClassification(
        nlp.BertConfig.tiny(use_recompute=True, **cfg), device='cpu').train()
    remat.load_state_dict(plain.state_dict())
    ids, _, _ = _inputs(seed=9)
    ids, labels = torch.from_numpy(ids), torch.tensor([1, 0])
    lp, gp = _grads(plain, ids, labels, seed=5)
    lr, gr = _grads(remat, ids, labels, seed=5)
    assert lp == lr
    for name in gp:
        assert torch.equal(gp[name], gr[name]), name
    if dropout:
        l2, _ = _grads(plain, ids, labels, seed=6)
        assert l2 != lp
