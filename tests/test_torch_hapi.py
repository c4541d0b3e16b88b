"""`hapi.Model`, the port against the JAX package, on the CPU.

A small classifier (two linear layers, the same weights in both
packages) under `prepare(AdamW, CrossEntropyLoss, Accuracy)`: `fit` (its
history), `evaluate` (loss and accuracy) and `predict` equal the JAX
`Model`'s on the same seeded data and shuffle order (losses rtol 1e-5,
parameters atol 4e-5, as tests/test_torch_train.py; accuracy exactly).
The tiny GQA Llama under `fit(ckpt_dir=, ckpt_interval=4, fault_tolerance,
step_timeout)`: a fresh `Model` with `resume='auto'` from the step-4
checkpoint gives steps 5-8's losses bit for bit, and a checkpoint written
by either package resumes in the other with the other's losses.
"""
import os
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as jio
import paddle_tpu.metric as jmetric
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import programs
from paddle_tpu.hapi import Model as JaxModel
from paddle_tpu.optimizer import AdamW as JaxAdamW
import paddle_tpu_torch as ptt
from paddle_tpu_torch import Model
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.weights import from_jax_state

from test_torch_observability import isolated_observability
from test_torch_train import (LOSS_RTOL, PARAM_ATOL, _jax_loss, _models,
                              _torch_loss)

LR = 1e-2


@pytest.fixture(autouse=True, scope='module')
def _isolated(tmp_path_factory):
    yield from isolated_observability(tmp_path_factory)


class JaxNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(6, 16)
        self.fc2 = jnn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(JF.relu(self.fc1(x)))


class TorchNet(tnn.Layer):
    def __init__(self):
        super().__init__()
        kw = dict(bias=True, device=torch.device('cpu'), dtype=torch.float32)
        self.fc1 = tnn.Linear(6, 16, **kw)
        self.fc2 = tnn.Linear(16, 4, **kw)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _nets(seed=3):
    paddle.seed(seed)
    jnet = JaxNet()
    state = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    return jnet, from_jax_state(state, TorchNet())


def _data(n=40, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 6).astype(np.float32)
    y = (x[:, :4].argmax(-1)).astype(np.int64)
    return x, y


def _classifiers():
    programs.get_store().clear_memory()
    jnet, tnet = _nets()
    jm = JaxModel(jnet).prepare(
        JaxAdamW(learning_rate=LR, parameters=jnet.parameters()),
        jnn.CrossEntropyLoss(), jmetric.Accuracy())
    tm = Model(tnet).prepare(
        AdamW(learning_rate=LR, parameters=tnet.parameters()),
        tnn.CrossEntropyLoss(), tmetric.Accuracy())
    return jm, tm


def _close_params(jnet, tnet):
    jsd = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    for name, p in tnet.state_dict().items():
        np.testing.assert_allclose(p.numpy(), jsd[name], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


@pytest.mark.parametrize('num_workers', [0, 2])
def test_fit_evaluate_predict_match_jax(num_workers):
    jm, tm = _classifiers()
    x, y = _data()
    kw = dict(batch_size=8, epochs=3, verbose=0, shuffle=True,
              num_workers=num_workers)
    jh = jm.fit(jio.TensorDataset([x, y]), **kw)
    th = tm.fit(tio.TensorDataset([x, y]), **kw)
    assert len(th['loss']) == len(jh['loss']) == 15
    np.testing.assert_allclose(th['loss'], jh['loss'], rtol=LOSS_RTOL)
    _close_params(jm.network, tm.network)
    xe, ye = _data(24, seed=2)
    je = jm.evaluate(jio.TensorDataset([xe, ye]), batch_size=5, verbose=0)
    te = tm.evaluate(tio.TensorDataset([xe, ye]), batch_size=5, verbose=0)
    assert te.keys() == je.keys() == {'loss', 'acc'}
    np.testing.assert_allclose(te['loss'], je['loss'], rtol=LOSS_RTOL)
    assert te['acc'] == je['acc']
    jp = jm.predict(jio.TensorDataset([xe]), batch_size=5,
                    stack_outputs=True)
    tp = tm.predict(tio.TensorDataset([xe]), batch_size=5,
                    stack_outputs=True)
    np.testing.assert_allclose(tp[0], np.asarray(jp[0]), rtol=1e-5,
                               atol=1e-5)


def test_fit_with_eval_data_and_callbacks_matches_jax():
    jm, tm = _classifiers()
    x, y = _data()
    xe, ye = _data(16, seed=5)
    hist = []
    for m, io_mod in ((jm, jio), (tm, tio)):
        seen = []
        cb_mod = paddle.callbacks if m is jm else ptt.callbacks

        class Log(cb_mod.Callback):
            def on_epoch_end(self, epoch, logs=None):
                seen.append({k: v for k, v in (logs or {}).items()})
        m.fit(io_mod.TensorDataset([x, y]), io_mod.TensorDataset([xe, ye]),
              batch_size=10, epochs=2, verbose=0, callbacks=[Log()])
        hist.append(seen)
    assert [sorted(h) for h in hist[1]] == [sorted(h) for h in hist[0]]
    for a, b in zip(hist[0], hist[1]):
        np.testing.assert_allclose(b['eval_loss'], a['eval_loss'],
                                   rtol=LOSS_RTOL)
        assert b['eval_acc'] == a['eval_acc']


def test_train_and_eval_batch_match_jax():
    jm, tm = _classifiers()
    x, y = _data(8)
    for _ in range(3):
        jl = jm.train_batch([x], y)
        tl = tm.train_batch([torch.from_numpy(x)], torch.from_numpy(y))
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    je = jm.eval_batch([x], paddle.to_tensor(y))
    te = tm.eval_batch([torch.from_numpy(x)], torch.from_numpy(y))
    np.testing.assert_allclose(te['loss'], je['loss'], rtol=LOSS_RTOL)


def test_save_and_load_roundtrip(tmp_path):
    _, tm = _classifiers()
    x, y = _data(8)
    for _ in range(2):
        tm.train_batch([torch.from_numpy(x)], torch.from_numpy(y))
    path = str(tmp_path / 'ck' / 'model')
    tm.save(path)
    assert os.path.exists(path + '.pdparams') and \
        os.path.exists(path + '.pdopt')
    _, tnet2 = _nets(seed=9)
    m2 = Model(tnet2).prepare(
        AdamW(learning_rate=LR, parameters=tnet2.parameters()),
        tnn.CrossEntropyLoss())
    m2.load(path)
    for (n, a), b in zip(tm.network.state_dict().items(),
                         m2.network.state_dict().values()):
        assert torch.equal(a, b), n
    want = tm.train_batch([torch.from_numpy(x)], torch.from_numpy(y))
    got = m2.train_batch([torch.from_numpy(x)], torch.from_numpy(y))
    assert got == want

    class Other(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc9 = tnn.Linear(6, 4, device=torch.device('cpu'),
                                  dtype=torch.float32)
    with pytest.raises(RuntimeError, match='state mismatch'):
        Model(Other()).load(path)


def test_summary_counts_parameters_and_flops(capsys):
    """`Model.summary` against the JAX one on the same network: the
    parameter counts, and with `input_size` the dict and the printed
    table of `utils.flops.summary`; `flops` counts what the JAX one
    does."""
    jnet, tnet = _nets()
    jm, tm = JaxModel(jnet), Model(tnet)
    plain = tm.summary()
    assert plain == jm.summary() == {'total_params': 180,
                                     'trainable_params': 180}
    capsys.readouterr()
    full = tm.summary(input_size=(2, 6))
    table = capsys.readouterr().out
    assert full == jm.summary(input_size=(2, 6)) == plain
    assert table == capsys.readouterr().out
    assert 'fc2 (Linear)' in table and '[2, 4]' in table
    assert ptt.flops(tnet, [2, 6]) == paddle.flops(jnet, [2, 6]) == \
        2 * 2 * (6 * 16 + 16 * 4)


def test_unported_options_name_roadmap():
    _, tm = _classifiers()
    # amp_configs is ported: O2 prepares (the network cast to bf16, fp32
    # masters in the optimizer) and trains
    net = TorchNet()
    o2 = Model(net).prepare(
        AdamW(learning_rate=LR, parameters=net.parameters()),
        tnn.CrossEntropyLoss(), amp_configs='O2')
    assert net.fc1.weight.dtype == torch.bfloat16
    assert o2._optimizer._multi_precision
    x, y = _data(16)
    hist = o2.fit(tio.TensorDataset([x, y]), batch_size=8, verbose=0)
    assert len(hist['loss']) == 2 and np.isfinite(hist['loss']).all()
    assert net.fc1.weight.dtype == torch.bfloat16
    Model(TorchNet()).prepare(amp_configs={'level': 'O0'})
    with pytest.raises(ValueError, match='amp level'):
        Model(TorchNet()).prepare(amp_configs='O3')
    x, y = _data(8)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        tm.fit(tio.TensorDataset([x, y]), elastic=True, verbose=0)
    with pytest.raises(NotImplementedError):
        tm.fit(tio.TensorDataset([x, y]), accumulate_grad_batches=2,
               verbose=0)
    with pytest.raises(ValueError, match='ckpt_dir'):
        tm.fit(tio.TensorDataset([x, y]), resume='auto', verbose=0)


# ---------------------------------------------------------------------------
# Llama: checkpoints, resume, fault tolerance
# ---------------------------------------------------------------------------

def _tokens(n=16, seq=12, seed=4):
    ids = np.random.RandomState(seed).randint(0, 128, (n, seq))
    return ids, ids


def _llama_model(pkg, seed=7):
    programs.get_store().clear_memory()
    jm, tm = _models(False, seed=seed)
    if pkg == 'jax':
        return JaxModel(jm).prepare(
            JaxAdamW(learning_rate=1e-3, parameters=jm.parameters()),
            _jax_loss)
    return Model(tm).prepare(
        AdamW(learning_rate=1e-3, parameters=tm.parameters()), _torch_loss)


def _fit(model, ckpt, resume=None, pkg='torch', **kw):
    io_mod = jio if pkg == 'jax' else tio
    return model.fit(io_mod.TensorDataset(list(_tokens())), batch_size=2,
                     epochs=1, shuffle=True, verbose=0, ckpt_dir=ckpt,
                     ckpt_interval=4, resume=resume, **kw)['loss']


@pytest.mark.parametrize('offload', [None, 'host'])
def test_resume_auto_is_bit_exact(tmp_path, offload):
    ft = dict(fault_tolerance=True, step_timeout=30.0)
    m = _llama_model('torch')
    if offload:
        m._optimizer = AdamW(learning_rate=1e-3,
                             parameters=m.network.parameters(),
                             offload='host')
    full = _fit(m, str(tmp_path / 'ck'), **ft)
    assert len(full) == 8
    assert sorted(os.listdir(tmp_path / 'ck')) == ['step_4', 'step_8']
    shutil.rmtree(tmp_path / 'ck' / 'step_8')
    fresh = _llama_model('torch')
    if offload:
        fresh._optimizer = AdamW(learning_rate=1e-3,
                                 parameters=fresh.network.parameters(),
                                 offload='host')
    rest = _fit(fresh, str(tmp_path / 'ck'), resume='auto', **ft)
    assert rest == full[4:]
    for a, b in zip(m.network.state_dict().values(),
                    fresh.network.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize('writer,reader', [('jax', 'torch'),
                                           ('torch', 'jax')])
def test_checkpoints_cross_between_the_packages(tmp_path, writer, reader):
    """Four steps written by one package; the other resumes them and its
    last four losses equal the writer's uninterrupted run."""
    full = _fit(_llama_model(writer), str(tmp_path / 'a'), pkg=writer)
    shutil.copytree(tmp_path / 'a', tmp_path / 'b')
    shutil.rmtree(tmp_path / 'b' / 'step_8')
    rest = _fit(_llama_model(reader, seed=99), str(tmp_path / 'b'),
                resume='auto', pkg=reader)
    np.testing.assert_allclose(rest, full[4:], rtol=LOSS_RTOL)


def test_fit_skips_a_nan_batch_with_fault_tolerance(tmp_path):
    m = _llama_model('torch')
    calls = []
    base = m._loss

    def loss(logits, labels):
        calls.append(1)
        out = base(logits, labels)
        return out * float('nan') if len(calls) == 3 else out
    m.prepare(m._optimizer, loss)
    hist = m.fit(tio.TensorDataset(list(_tokens())), batch_size=2,
                 epochs=1, verbose=0, shuffle=False,
                 fault_tolerance={'check_spikes': False})
    assert len(hist['loss']) == 7 and np.isfinite(hist['loss']).all()
    assert hist['resilience']['rollbacks'] == 1


def test_fit_preemption_saves_and_stops(tmp_path):
    m = _llama_model('torch')
    calls = []

    class Preempt(ptt.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            calls.append(step)
            if step == 2:
                import signal
                os.kill(os.getpid(), signal.SIGTERM)
    hist = m.fit(tio.TensorDataset(list(_tokens())), batch_size=2,
                 epochs=2, verbose=0, ckpt_dir=str(tmp_path / 'p'),
                 ckpt_interval=100, callbacks=[Preempt()])
    assert len(hist['loss']) == 3 and calls == [0, 1, 2]
    assert os.listdir(tmp_path / 'p') == ['step_3']
