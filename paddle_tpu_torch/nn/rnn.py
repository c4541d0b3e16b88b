"""Recurrent layers (counterpart of `paddle_tpu/nn/rnn.py`): SimpleRNN,
LSTM, GRU, their cells, and RNN / BiRNN over any cell.

The cell math is the JAX package's, written out (not torch.nn.LSTM or
cuDNN, so the gate order and the bias placement cannot drift): LSTM
gates i, f, g, o from x W_ih^T + b_ih + h W_hh^T + b_hh; GRU r, u, c with
c = tanh(x_c + r * h_c) and h' = u * h + (1 - u) * c. Weights are
[gates * hidden, in] and [gates * hidden, hidden], biases [gates *
hidden], drawn uniform in +-1 / sqrt(hidden), under the JAX names
(`weight_ih_l0`, `weight_hh_l0_reverse`, ...). The time loop is a
Python loop over torch ops (the JAX `lax.scan` is a loop too); the input
projection of every step is one product before the loop.

`sequence_length` (a [batch] tensor of lengths): a step past a row's
length leaves that row's carry as it was and outputs zeros, so the
reverse direction starts at each row's own last step and the final
states are each row's last valid ones. This is the JAX `RNN` wrapper's
rule (`paddle_tpu/nn/rnn.py:311-340`); the JAX SimpleRNN / LSTM / GRU
layers take `sequence_length` and do not read it, so the port's layers
are held to the JAX wrapper over the same cells.
"""
from __future__ import annotations

import math

import torch

from ..tensor import apply_op
from . import functional as F
from . import initializer as I
from .layer import Layer


def _uniform_init(hidden_size):
    k = 1.0 / math.sqrt(hidden_size)
    return I.Uniform(-k, k)


def _simple_cell_tanh(h, xw, whh, bhh):
    h2 = torch.tanh(xw + h @ whh.t() + bhh)
    return h2, h2


def _simple_cell_relu(h, xw, whh, bhh):
    h2 = torch.relu(xw + h @ whh.t() + bhh)
    return h2, h2


def _lstm_cell(carry, xw, whh, bhh):
    h, c = carry
    z = xw + h @ whh.t() + bhh
    i, f, g, o = z.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c2 = f * c + i * torch.tanh(g)
    h2 = o * torch.tanh(c2)
    return (h2, c2), h2


def _gru_cell(h, xw, whh, bhh):
    hz = h @ whh.t() + bhh
    xr, xu, xc = xw.chunk(3, dim=-1)
    hr, hu, hc = hz.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    u = torch.sigmoid(xu + hu)
    c = torch.tanh(xc + r * hc)
    h2 = u * h + (1 - u) * c
    return h2, h2


def _masked(valid, new, old):
    if isinstance(new, tuple):
        return tuple(torch.where(valid, n, o) for n, o in zip(new, old))
    return torch.where(valid, new, old)


def _scan(cell, carry, xw, whh, bhh, reverse, lengths):
    """Run `cell` over xw [T, B, G * H] (the input projections, bias in);
    returns (outputs [T, B, H], the final carry)."""
    steps = xw.shape[0]
    outs = [None] * steps
    for t in (range(steps - 1, -1, -1) if reverse else range(steps)):
        new, out = cell(carry, xw[t], whh, bhh)
        if lengths is not None:
            valid = (lengths > t).unsqueeze(-1)
            out = torch.where(valid, out, torch.zeros_like(out))
            new = _masked(valid, new, carry)
        carry = new
        outs[t] = out
    return torch.stack(outs, dim=0), carry


class _RNNBase(Layer):
    GATES = 1
    _cell = None

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction='forward', time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        self.bidirectional = direction in ('bidirect', 'bidirectional')
        ndir = 2 if self.bidirectional else 1
        init = dict(default_initializer=_uniform_init(hidden_size),
                    device=device, dtype=dtype, generator=generator)
        g = self.GATES
        for layer in range(num_layers):
            for d in range(ndir):
                sfx = f'_l{layer}' + ('_reverse' if d else '')
                in_sz = input_size if layer == 0 else hidden_size * ndir
                self.add_parameter('weight_ih' + sfx, self.create_parameter(
                    (g * hidden_size, in_sz), **init))
                self.add_parameter('weight_hh' + sfx, self.create_parameter(
                    (g * hidden_size, hidden_size), **init))
                self.add_parameter('bias_ih' + sfx, self.create_parameter(
                    (g * hidden_size,), **init))
                self.add_parameter('bias_hh' + sfx, self.create_parameter(
                    (g * hidden_size,), **init))

    def _init_carry(self, batch, like):
        z = torch.zeros((batch, self.hidden_size), dtype=like.dtype,
                        device=like.device)
        return (z, z) if self.GATES == 4 else z

    def forward(self, x, initial_states=None, sequence_length=None):
        ndir = 2 if self.bidirectional else 1
        name = type(self).__name__.lower()
        layer_in = x
        finals = []
        for layer in range(self.num_layers):
            outs = []
            for d in range(ndir):
                sfx = f'_l{layer}' + ('_reverse' if d else '')
                idx = layer * ndir + d
                init_state = None
                if initial_states is not None:
                    if isinstance(initial_states, (tuple, list)):
                        init_state = tuple(s[idx] for s in initial_states)
                    else:
                        init_state = (initial_states[idx],)

                def f(v, wi, wh, bi, bh, lengths, *init_vals, reverse=bool(d)):
                    seq = v if self.time_major else v.transpose(0, 1)
                    if init_vals:
                        carry = tuple(init_vals) if len(init_vals) > 1 \
                            else init_vals[0]
                    else:
                        carry = self._init_carry(seq.shape[1], seq)
                    xw = seq @ wi.t() + bi
                    ys, carry = _scan(self._cell, carry, xw, wh, bh, reverse,
                                      lengths)
                    return (ys if self.time_major else ys.transpose(0, 1),
                            carry)

                args = [layer_in] + [getattr(self, p + sfx) for p in
                                     ('weight_ih', 'weight_hh', 'bias_ih',
                                      'bias_hh')] + [sequence_length]
                if init_state is not None:
                    args += list(init_state)
                ys, carry = apply_op(f, *args, _name=name)
                outs.append(ys)
                finals.append(carry)
            layer_out = outs[0] if ndir == 1 else apply_op(
                lambda a, b: torch.cat([a, b], dim=-1), outs[0], outs[1],
                _name='concat')
            if self.dropout and layer < self.num_layers - 1:
                layer_out = F.dropout(layer_out, self.dropout,
                                      training=self.training)
            layer_in = layer_out
        if isinstance(finals[0], tuple):
            final_state = tuple(
                apply_op(lambda *hs: torch.stack(hs, dim=0),
                         *[fc[i] for fc in finals], _name='stack')
                for i in range(len(finals[0])))
        else:
            final_state = apply_op(lambda *hs: torch.stack(hs, dim=0),
                                   *finals, _name='stack')
        return layer_out, final_state


class SimpleRNN(_RNNBase):
    GATES = 1

    def __init__(self, *args, activation='tanh', **kwargs):
        self._act = activation
        super().__init__(*args, **kwargs)
        self._cell = _simple_cell_tanh if activation == 'tanh' \
            else _simple_cell_relu


class LSTM(_RNNBase):
    GATES = 4
    _cell = staticmethod(_lstm_cell)


class GRU(_RNNBase):
    GATES = 3
    _cell = staticmethod(_gru_cell)


class RNNCellBase(Layer):
    """One recurrent step (paddle.nn.SimpleRNNCell / LSTMCell / GRUCell):
    `forward(inputs, states)` -> (output, new states)."""
    GATES = 1
    STATES = 1
    _step = None

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        init = dict(default_initializer=_uniform_init(hidden_size),
                    device=device, dtype=dtype, generator=generator)
        g = self.GATES
        self.weight_ih = self.create_parameter(
            (g * hidden_size, input_size), attr=weight_ih_attr, **init)
        self.weight_hh = self.create_parameter(
            (g * hidden_size, hidden_size), attr=weight_hh_attr, **init)
        self.bias_ih = self.create_parameter(
            (g * hidden_size,), attr=bias_ih_attr, is_bias=True, **init)
        self.bias_hh = self.create_parameter(
            (g * hidden_size,), attr=bias_hh_attr, is_bias=True, **init)

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        from ..dtype import convert_dtype
        b = batch_ref.shape[batch_dim_idx]
        dt = convert_dtype(dtype or 'float32')

        def mk():
            return apply_op(lambda ref: torch.full(
                (b, self.hidden_size), init_value, dtype=dt,
                device=ref.device), batch_ref, _name='full')
        return (mk(), mk()) if self.STATES == 2 else mk()

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        single = self.STATES == 1
        sts = (states,) if single else tuple(states)
        step = self._step

        def f(x, wih, whh, bih, bhh, *st):
            carry = st[0] if single else tuple(st)
            carry2, out = step(carry, x @ wih.t() + bih, whh, bhh)
            return (out, carry2) if single else (out,) + tuple(carry2)
        res = apply_op(f, inputs, self.weight_ih, self.weight_hh,
                       self.bias_ih, self.bias_hh, *sts,
                       _name=type(self).__name__.lower())
        if single:
            return res[0], res[1]
        return res[0], tuple(res[1:])


class SimpleRNNCell(RNNCellBase):
    GATES = 1
    STATES = 1

    def __init__(self, input_size, hidden_size, activation='tanh',
                 **kwargs):
        super().__init__(input_size, hidden_size, **kwargs)
        self.activation = activation
        self._step = _simple_cell_tanh if activation == 'tanh' \
            else _simple_cell_relu


class LSTMCell(RNNCellBase):
    GATES = 4
    STATES = 2
    _step = staticmethod(_lstm_cell)


class GRUCell(RNNCellBase):
    GATES = 3
    STATES = 1
    _step = staticmethod(_gru_cell)


class RNN(Layer):
    """Any cell over a sequence (paddle.nn.RNN), a Python step loop; with
    `sequence_length`, pad steps keep the carry and output zeros."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        axis = 0 if self.time_major else 1
        steps = inputs.shape[axis]
        states = initial_states
        if sequence_length is not None and states is None:
            ref = inputs[0] if self.time_major else inputs[:, 0]
            states = self.cell.get_initial_states(ref)
        outs = [None] * steps
        for t in (range(steps - 1, -1, -1) if self.is_reverse
                  else range(steps)):
            xt = inputs[t] if self.time_major else inputs[:, t]
            out, new_states = self.cell(xt, states)
            if sequence_length is not None:
                valid = (sequence_length > t).unsqueeze(-1)
                out = torch.where(valid, out, out * 0.0)
                states = _masked(valid, new_states, states)
            else:
                states = new_states
            outs[t] = out
        return torch.stack(outs, dim=axis), states


class BiRNN(Layer):
    """Forward and backward cells over one sequence, outputs concatenated
    (paddle.nn.BiRNN)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw, self.cell_bw = cell_fw, cell_bw
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        sf = sb = None
        if initial_states is not None:
            sf, sb = initial_states
        of, sf = self.rnn_fw(inputs, sf, sequence_length)
        ob, sb = self.rnn_bw(inputs, sb, sequence_length)
        return torch.cat([of, ob], dim=-1), (sf, sb)
