"""Automatic mixed precision (counterpart of `paddle_tpu/amp/`:
auto_cast, decorate, GradScaler).

`auto_cast` installs a per-thread policy that the op choke point
(`tensor.apply_op`) consults by op name, with the JAX package's lists
as they stand: white-list ops (the products) run in the low dtype,
black-list ops (softmax, norms, losses, sensitive reductions) are
pinned to fp32, and under O1 every other op follows its inputs; O2
casts every other op's fp32 inputs to the low dtype too. The policy
reaches the port's functional entries, so the training path's
projections and attention run in bf16 or fp16 (the flash kernels have
both) while RMSNorm and cross-entropy stay in fp32. `torch.autocast` is
not used: its op lists are not the JAX package's, so its casts would
differ. `decorate` (O2) casts the model once and has the optimizer keep
fp32 master weights (`multi_precision`). `GradScaler` scales the loss
for fp16 and skips the update of a step whose gradients overflowed.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterable, Optional

import torch

from . import debugging  # noqa: F401  (paddle.amp.debugging)
from .. import tensor as _tensor_mod
from ..dtype import convert_dtype

# matmul-class ops: compute-bound on the tensor cores, safe and fast in
# bf16/fp16
WHITE_LIST = {
    'matmul', 'mm', 'bmm', 'linear', 'dot', 'einsum', 'addmm', 'mv',
    'conv1d', 'conv2d', 'conv3d', 'conv1d_transpose', 'conv2d_transpose',
    'conv3d_transpose', 'scaled_dot_product_attention', 'bilinear',
}
# numerically-sensitive ops: keep fp32 accumulate/range
BLACK_LIST = {
    'softmax', 'log_softmax', 'cross_entropy', 'nll_loss', 'kl_div',
    'binary_cross_entropy', 'binary_cross_entropy_with_logits',
    'softmax_with_cross_entropy', 'layer_norm', 'batch_norm', 'rms_norm',
    'group_norm', 'instance_norm', 'local_response_norm', 'norm',
    'logsumexp', 'log', 'log2', 'log10', 'log1p', 'exp', 'expm1', 'pow',
    'cumsum', 'cumprod', 'sum', 'mean', 'std', 'var', 'sigmoid_focal_loss',
    'mse_loss', 'l1_loss', 'smooth_l1_loss', 'cosine_similarity',
}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = 'O1'
        self.white = WHITE_LIST
        self.black = BLACK_LIST


_state = _AmpState()
# enabled auto_cast scopes open in any thread: the choke point's hook is
# installed only while there is one, so an op outside AMP pays nothing
_open = {'n': 0}
_lock = threading.Lock()


def _cast_inputs(vals, op_name):
    """The apply_op hook: the inputs cast by the active policy (the same
    list when nothing is cast)."""
    if not _state.enabled:
        return vals
    if op_name in _state.black:
        want, cast = torch.float32, lambda v: v.is_floating_point() and \
            v.dtype != torch.float32
    elif op_name in _state.white or _state.level == 'O2':
        want, cast = _state.dtype, lambda v: v.dtype == torch.float32
    else:
        return vals
    if not any(cast(v) for v in vals):
        return vals
    return [v.to(want) if cast(v) else v for v in vals]


def _scope(delta: int) -> None:
    with _lock:
        _open['n'] += delta
        _tensor_mod._amp_cast_hook = _cast_inputs if _open['n'] else None


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list: Optional[Iterable[str]] = None,
              custom_black_list: Optional[Iterable[str]] = None,
              level='O1', dtype='bfloat16', use_promote=True):
    """The mixed-precision op policy for the ops run inside (Paddle's
    paddle.amp.auto_cast)."""
    if level not in ('O0', 'O1', 'O2'):
        raise ValueError(f'amp level must be O0/O1/O2, got {level!r}')
    cw = set(custom_white_list or ())
    cb = set(custom_black_list or ())
    if cw & cb:  # validate BEFORE touching state (no partial mutation)
        raise ValueError(f'ops in both custom lists: {sorted(cw & cb)}')
    new_dtype = convert_dtype(dtype)
    old = (_state.enabled, _state.dtype, _state.level, _state.white,
           _state.black)
    _state.enabled = bool(enable) and level != 'O0'
    _state.dtype = new_dtype
    _state.level = level
    # custom entries override the built-in opposite list
    _state.white = (WHITE_LIST | cw) - cb
    _state.black = (BLACK_LIST | cb) - cw
    _scope(1)
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level, _state.white,
         _state.black) = old
        _scope(-1)


amp_guard = auto_cast  # the legacy name (paddle.fluid.dygraph.amp)


def _policy() -> tuple:
    """This thread's policy."""
    return (_state.enabled, _state.dtype, _state.level, _state.white,
            _state.black)


def keep_policy(fn):
    """`fn`, run under the policy active now wherever it is called later:
    the recompute of a checkpointed layer in the backward runs the
    forward again under the forward's policy, as the JAX package's traced
    recompute keeps its casts. `fn` itself when no policy is active."""
    if not _state.enabled:
        return fn
    policy = _policy()

    def run(*args, **kwargs):
        with _restored(policy):
            return fn(*args, **kwargs)
    return run


@contextlib.contextmanager
def _restored(policy: tuple):
    old = _policy()
    (_state.enabled, _state.dtype, _state.level, _state.white,
     _state.black) = policy
    _scope(1)
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level, _state.white,
         _state.black) = old
        _scope(-1)


def decorate(models, optimizers=None, level='O2', dtype='bfloat16',
             master_weight=True, save_dtype=None):
    """O2 decoration: cast the models' parameters to the low dtype, and
    have the optimizers keep fp32 master weights (Paddle's
    paddle.amp.decorate)."""
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == 'O2':
        for m in model_list:
            m.to(dtype=convert_dtype(dtype))
    if optimizers is not None:
        single_opt = not isinstance(optimizers, (list, tuple))
        opt_list = [optimizers] if single_opt else list(optimizers)
        for opt in opt_list:
            if master_weight:
                opt._multi_precision = True
        if single_model and single_opt:
            return model_list[0], opt_list[0]
        return model_list, opt_list
    return model_list[0] if single_model else model_list


class GradScaler:
    """Dynamic loss scaling (Paddle's paddle.amp.GradScaler).

    Needed for fp16, whose narrow exponent range a loss's gradients can
    leave: `scale` multiplies the loss, `unscale_` divides the gradients
    back and finds a non-finite one with one device-to-host read for the
    whole parameter set, `step` skips the update of such a step, and
    `update` halves the scale after `decr_every_n_nan_or_inf` bad steps
    and doubles it after `incr_every_n_steps` good ones. For bf16 it is
    a correct pass-through."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5,
                 incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
                 use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def is_enable(self):
        return self._enable

    def get_loss_scaling(self):
        return self._scale

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    @staticmethod
    def _params_of(optimizer):
        return [p for p in optimizer._params() if p.grad is not None]

    def unscale_(self, optimizer):
        if not self._enable or self._unscaled:
            return
        grads = [p.grad for p in self._params_of(optimizer)]
        if grads:
            torch._foreach_mul_(grads, 1.0 / self._scale)
            finite = torch.stack([torch.isfinite(g).all() for g in grads])
            # one device-to-host read for the whole parameter set
            self._found_inf = not bool(finite.all())
        else:
            self._found_inf = False
        self._unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def update(self):
        if not self._enable or not self._dynamic:
            self._unscaled = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False
        self._unscaled = False

    def minimize(self, optimizer, scaled_loss):
        # scaled_loss.backward() must already have run
        self.step(optimizer)
        self.update()
        optimizer.clear_grad()


def is_bfloat16_supported(device=None):
    """bf16 runs on the tensor cores of compute capability 8.0 and up
    (an H100 is 9.0); the CPU computes it too."""
    if torch.cuda.is_available() and str(device or 'gpu') != 'cpu':
        return torch.cuda.get_device_capability() >= (8, 0)
    return True


def is_float16_supported(device=None):
    """fp16 runs on the tensor cores of compute capability 7.0 and up."""
    if torch.cuda.is_available() and str(device or 'gpu') != 'cpu':
        return torch.cuda.get_device_capability() >= (7, 0)
    return True
