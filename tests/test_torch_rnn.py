"""The port's recurrent layers (paddle_tpu_torch/nn/rnn.py) against the
JAX package's, on the CPU: SimpleRNN (tanh and relu), LSTM and GRU with
two layers, forward and bidirectional, batch- and time-major, with and
without initial states, their gradients against `jax.grad`, the cells,
`RNN` and `BiRNN`; and `sequence_length`, held to the JAX `RNN` / `BiRNN`
wrappers over the JAX cells carrying the same weights (the JAX layers
take `sequence_length` and do not read it).

Tolerance: f32, rtol 1e-4 and atol 1e-5 (the port projects every step's
input in one product before the loop, the JAX scan one step at a time).
Inputs are made from a seed with numpy and handed to both."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.weights import from_jax_state

RTOL, ATOL = 1e-4, 1e-5
IN, HID, BATCH, STEPS = 5, 6, 3, 7


@pytest.fixture(autouse=True, scope='module')
def _cpu_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ptt.set_device('cpu')
    yield
    ptt.set_device('gpu')
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.numpy())


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _pair(name, **kw):
    paddle.seed(5)
    jl = getattr(jnn, name)(IN, HID, **kw)
    tl = getattr(tnn, name)(IN, HID, **kw)
    assert list(tl.state_dict()) == list(jl.state_dict())
    from_jax_state(_state(jl), tl)
    return jl, tl


def _states(name, rng, ndir, layers=2):
    shape = (layers * ndir, BATCH, HID)
    if name == 'LSTM':
        return (rng.standard_normal(shape).astype(np.float32),
                rng.standard_normal(shape).astype(np.float32))
    return rng.standard_normal(shape).astype(np.float32)


LAYER_CASES = [
    ('SimpleRNN', {'num_layers': 2}, False),
    ('SimpleRNN', {'num_layers': 2, 'activation': 'relu',
                   'direction': 'bidirect'}, True),
    ('LSTM', {'num_layers': 2, 'direction': 'bidirect'}, False),
    ('LSTM', {'num_layers': 2, 'time_major': True}, True),
    ('GRU', {'num_layers': 2, 'direction': 'bidirectional'}, True),
    ('GRU', {'num_layers': 2, 'time_major': True,
             'direction': 'bidirect'}, False),
]


@pytest.mark.parametrize('case', LAYER_CASES,
                         ids=[f'{c[0]}-{i}' for i, c in
                              enumerate(LAYER_CASES)])
def test_rnn_layer_matches_jax(case):
    """Outputs and final states (stacked [layers x directions, batch,
    hidden]; LSTM's (h, c)) against the JAX layer with the same weights,
    from zeros or from given initial states."""
    name, kw, with_init = case
    jl, tl = _pair(name, **kw)
    rng = np.random.default_rng(len(kw) + with_init)
    tm = kw.get('time_major', False)
    x = rng.standard_normal((STEPS, BATCH, IN) if tm else
                            (BATCH, STEPS, IN)).astype(np.float32)
    ndir = 2 if kw.get('direction', 'forward') != 'forward' else 1
    init = _states(name, rng, ndir) if with_init else None
    if init is None:
        jo, js = jl(paddle.to_tensor(x))
        to, ts = tl(torch.from_numpy(x))
    elif isinstance(init, tuple):
        jo, js = jl(paddle.to_tensor(x), tuple(paddle.to_tensor(s)
                                               for s in init))
        to, ts = tl(torch.from_numpy(x), tuple(torch.from_numpy(s)
                                               for s in init))
    else:
        jo, js = jl(paddle.to_tensor(x), paddle.to_tensor(init))
        to, ts = tl(torch.from_numpy(x), torch.from_numpy(init))
    assert tuple(to.shape) == tuple(jo.shape)
    _close(_np(to), _np(jo))
    for got, want in zip(ts if isinstance(ts, tuple) else (ts,),
                         js if isinstance(js, tuple) else (js,)):
        _close(_np(got), _np(want))


@pytest.mark.parametrize('name', ['LSTM', 'GRU'])
def test_rnn_layer_gradients_match_jax(name):
    """d/dx and d/dW of sum(out * cot) for a 2-layer bidirectional layer,
    against the JAX layer's gradients (rtol 1e-4, atol 1e-5)."""
    jl, tl = _pair(name, num_layers=2, direction='bidirect')
    rng = np.random.default_rng(11)
    x = rng.standard_normal((BATCH, STEPS, IN)).astype(np.float32)
    cot = rng.standard_normal((BATCH, STEPS, 2 * HID)).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x).requires_grad_()
    (jl(jx)[0] * paddle.to_tensor(cot)).sum().backward()
    (tl(tx)[0] * torch.from_numpy(cot)).sum().backward()
    _close(tx.grad.numpy(), _np(jx.grad))
    for p in ('weight_ih_l0', 'weight_hh_l1_reverse', 'bias_hh_l0'):
        _close(getattr(tl, p).grad.numpy(), _np(getattr(jl, p).grad))


def _jax_cells(name, tl, layer, sfx):
    cell = getattr(jnn, name + 'Cell')(IN if layer == 0 else 2 * HID, HID)
    sd = tl.state_dict()
    cell.set_state_dict({k: paddle.to_tensor(sd[f'{k}_l{layer}{sfx}']
                                             .numpy())
                         for k in ('weight_ih', 'weight_hh', 'bias_ih',
                                   'bias_hh')})
    return cell


@pytest.mark.parametrize('name,tm', [('LSTM', False), ('GRU', True),
                                     ('SimpleRNN', False)])
def test_sequence_length_matches_the_jax_wrapper(name, tm):
    """With `sequence_length`, a 2-layer bidirectional layer equals the
    JAX BiRNN wrapper over the JAX cells with the same weights, layer by
    layer: steps past a row's length output zeros and keep the carry, the
    reverse direction starts at each row's own last step, the final
    states are each row's last valid ones."""
    _, tl = _pair(name, num_layers=2, direction='bidirect', time_major=tm)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((STEPS, BATCH, IN) if tm else
                            (BATCH, STEPS, IN)).astype(np.float32)
    lens = np.array([STEPS, 2, 5], np.int64)
    to, ts = tl(torch.from_numpy(x), sequence_length=torch.from_numpy(lens))
    inp, finals = paddle.to_tensor(x), []
    for layer in range(2):
        bi = jnn.BiRNN(_jax_cells(name, tl, layer, ''),
                       _jax_cells(name, tl, layer, '_reverse'),
                       time_major=tm)
        inp, (sf, sb) = bi(inp, sequence_length=paddle.to_tensor(lens))
        finals += [sf, sb]
    _close(_np(to), _np(inp))
    row1 = _np(to)[:, 1] if tm else _np(to)[1]     # length 2
    assert not row1[2:].any() and row1[:2].all()
    if name == 'LSTM':
        for i in range(2):
            _close(_np(ts[i]), np.stack([_np(f[i]) for f in finals]))
    else:
        _close(_np(ts), np.stack([_np(f) for f in finals]))


@pytest.mark.parametrize('name', ['SimpleRNNCell', 'LSTMCell', 'GRUCell'])
def test_cells_rnn_and_birnn_match_jax(name):
    """One step of each cell from given states; `RNN` over a cell
    (reverse) and `BiRNN` with `sequence_length`, against the JAX ones
    with the same weights."""
    paddle.seed(7)
    jc = getattr(jnn, name)(IN, HID)
    tc = getattr(tnn, name)(IN, HID)
    from_jax_state(_state(jc), tc)
    rng = np.random.default_rng(17)
    x = rng.standard_normal((BATCH, IN)).astype(np.float32)
    h = rng.standard_normal((BATCH, HID)).astype(np.float32)
    st = (h, h[::-1].copy()) if name == 'LSTMCell' else h
    j_st = tuple(paddle.to_tensor(s) for s in st) \
        if isinstance(st, tuple) else paddle.to_tensor(st)
    t_st = tuple(torch.from_numpy(s) for s in st) \
        if isinstance(st, tuple) else torch.from_numpy(st)
    jo, jn = jc(paddle.to_tensor(x), j_st)
    to, tn = tc(torch.from_numpy(x), t_st)
    _close(_np(to), _np(jo))
    for got, want in zip(tn if isinstance(tn, tuple) else (tn,),
                         jn if isinstance(jn, tuple) else (jn,)):
        _close(_np(got), _np(want))

    seq = rng.standard_normal((BATCH, STEPS, IN)).astype(np.float32)
    lens = np.array([3, STEPS, 1], np.int64)
    jo, _ = jnn.RNN(jc, is_reverse=True)(paddle.to_tensor(seq))
    to, _ = tnn.RNN(tc, is_reverse=True)(torch.from_numpy(seq))
    _close(_np(to), _np(jo))
    jc2 = getattr(jnn, name)(IN, HID)
    tc2 = getattr(tnn, name)(IN, HID)
    from_jax_state(_state(jc2), tc2)
    jo, (jf, jb) = jnn.BiRNN(jc, jc2)(paddle.to_tensor(seq),
                                      sequence_length=paddle.to_tensor(lens))
    to, (tf_, tb) = tnn.BiRNN(tc, tc2)(torch.from_numpy(seq),
                                       sequence_length=torch.from_numpy(lens))
    _close(_np(to), _np(jo))
    for got, want in ((tf_, jf), (tb, jb)):
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            _close(_np(g), _np(w))


def test_rnn_weights_draw_uniform_in_the_hidden_bound():
    """Every weight and bias of the layers and cells draws uniform in
    +-1 / sqrt(hidden), under the JAX names and shapes."""
    ptt.seed(1)
    layer = tnn.LSTM(16, 64, num_layers=2, direction='bidirect')
    names = [n for n, _ in layer.named_parameters()]
    assert names[:4] == ['weight_ih_l0', 'weight_hh_l0', 'bias_ih_l0',
                         'bias_hh_l0'] and names[4] == 'weight_ih_l0_reverse'
    assert tuple(layer.weight_ih_l1.shape) == (256, 128)
    bound = 1 / np.sqrt(64)
    for _, p in layer.named_parameters():
        v = p.detach().numpy()
        assert np.abs(v).max() <= bound
        assert v.std() > 0.8 * bound / np.sqrt(3)
