"""paddle.flops and paddle.summary (counterpart of
`paddle_tpu/utils/flops.py`; upstream: python/paddle/hapi/dynamic_flops.py
and model_summary.py): per-layer counts through forward hooks over one
dry-run forward on zeros.

The JAX package's table and conventions: 2 * MACs for `Linear` and the
convolutions, nothing for `Embedding` (a gather), 2 per input element
for a norm, 1 per output element for a pooling layer or an activation;
containers and unknown layers count through their children.
`custom_ops` maps a layer class to fn(layer, inputs, output) -> FLOPs
and overrides the table. The dry run feeds float32 zeros of
`input_size` on the network's device, as the JAX package feeds float
zeros (so a network whose first layer is an embedding fails there, in
both packages).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_ACTIVATIONS = ('ReLU', 'GELU', 'Sigmoid', 'Tanh', 'Hardswish',
                'Hardsigmoid', 'Swish', 'ReLU6', 'LeakyReLU', 'Softmax')


def _out_shape(out):
    if isinstance(out, (tuple, list)):
        out = out[0]
    return tuple(int(s) for s in out.shape)


def _count(layer, inputs, out) -> Optional[int]:
    from ..nn.common_layers import Embedding, Linear
    from ..nn.conv import _ConvNd
    in_shape = tuple(int(s) for s in inputs[0].shape) if inputs else ()
    o = _out_shape(out)
    if isinstance(layer, Linear):
        rows = int(np.prod(o[:-1])) if len(o) > 1 else 1
        return 2 * rows * layer.in_features * layer.out_features
    if isinstance(layer, _ConvNd):
        k = int(np.prod(layer.kernel_size))
        in_c = layer.in_channels // layer.groups
        return 2 * int(np.prod(o)) * in_c * k
    if isinstance(layer, Embedding):
        return 0  # gather, no FLOPs by upstream convention
    name = type(layer).__name__
    if 'Norm' in name:
        return 2 * int(np.prod(in_shape))
    if 'Pool' in name or name in _ACTIVATIONS:
        return int(np.prod(o))
    return None  # containers and unknown layers: children count instead


def _n_params(params) -> int:
    return int(sum(p.numel() for p in params))


def _dry_run(net: torch.nn.Module, hooks, x):
    """Run `net` once on `x` in eval mode under no_grad, then remove
    `hooks` and restore the training flag."""
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(x)
    finally:
        for h in hooks:
            h.remove()
        net.train(was_training)


def _zeros(net: torch.nn.Module, input_size) -> torch.Tensor:
    p = next(net.parameters(), None)
    return torch.zeros(list(input_size), dtype=torch.float32,
                       device=None if p is None else p.device)


def summary(net: torch.nn.Module, input_size=None, dtypes=None,
            input=None) -> dict:
    """paddle.summary: one dry run (on `input`, or float32 zeros of
    `input_size`), then a table of each leaf layer's output shape and
    parameters; returns {'total_params', 'trainable_params'}."""
    rows = []
    hooks = []

    def make_hook(path):
        def hook(layer, inputs, out):
            if next(layer.children(), None) is not None:
                return  # leaf layers only, like upstream's table
            o = out[0] if isinstance(out, (tuple, list)) else out
            rows.append((path or type(layer).__name__,
                         type(layer).__name__,
                         list(getattr(o, 'shape', [])),
                         _n_params(layer.parameters(recurse=False))))
        return hook

    for path, sub in net.named_modules():
        hooks.append(sub.register_forward_hook(make_hook(path)))
    _dry_run(net, hooks, input if input is not None
             else _zeros(net, input_size))
    total = _n_params(net.parameters())
    trainable = _n_params(p for p in net.parameters() if p.requires_grad)
    header = f'{"Layer (type)":<40}{"Output Shape":<24}{"Param #":>12}'
    lines = [header, '-' * len(header)]
    for path, tname, shape, n in rows:
        lines.append(f'{path + " (" + tname + ")":<40}'
                     f'{str(shape):<24}{n:>12,}')
    lines += ['-' * len(header),
              f'Total params: {total:,}',
              f'Trainable params: {trainable:,}',
              f'Non-trainable params: {total - trainable:,}']
    print('\n'.join(lines))
    return {'total_params': total, 'trainable_params': trainable}


def flops(net: torch.nn.Module, input_size, custom_ops=None,
          print_detail: bool = False) -> int:
    """Dry-run `net` on float32 zeros of `input_size` and return its
    total FLOPs. `custom_ops` maps a layer CLASS to fn(layer, inputs,
    output) -> FLOPs, overriding the built-in table."""
    totals = {}
    hooks = []

    def make_hook(path):
        def hook(layer, inputs, out):
            fn = (custom_ops or {}).get(type(layer))
            n = fn(layer, inputs, out) if fn \
                else _count(layer, inputs, out)
            if n:
                totals[path] = totals.get(path, 0) + int(n)
        return hook

    for path, sub in net.named_modules():
        hooks.append(sub.register_forward_hook(make_hook(path or 'net')))
    _dry_run(net, hooks, _zeros(net, input_size))
    total = sum(totals.values())
    if print_detail:
        for path, n in sorted(totals.items()):
            print(f'{path:50s} {n:,}')
    print(f'Total Flops: {total:,}     Total Params: '
          f'{_n_params(net.parameters()):,}')
    return total
