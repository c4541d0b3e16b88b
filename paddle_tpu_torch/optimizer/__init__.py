"""Optimizers (counterpart of `paddle_tpu/optimizer/__init__.py`).

Each optimizer has the JAX package's per-parameter rule, computed as the
JAX package computes it per leaf: the gradient and the update in fp32,
the scalars (lr, bias corrections) in fp32 on the host. `weight_decay` is
a number or a `regularizer.L2Decay`/`L1Decay` added to the gradient
(coeff * p, coeff * sign(p)); AdamW's is decoupled, p <- p - lr * coeff * p
with p before the step, on every parameter unless
`apply_decay_param_fun(name)` says no. `learning_rate` is a number or an
`lr.LRScheduler`, read on the host at every update and stepped by the
caller. `grad_clip` (`nn.ClipGradByValue`, `ClipGradByNorm`,
`ClipGradByGlobalNorm`) clips the grads before the update and leaves
`.grad` as it was.

Adam's rule is Paddle's: Adam's bias correction folded into the step
size, lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t), and epsilon added
to sqrt(v) outside the correction, p <- p - lr_t * m / (sqrt(v) +
epsilon). `torch.optim.AdamW` places epsilon inside the correction and is
not used. `Adam` and `AdamW` (these two classes, not the subclasses with
rules of their own) update every parameter through
`ops.kernels.multi_tensor_adam`: on the card one multi-tensor kernel
launch per group of up to 48 tensors, with a global-norm clip's scale
from `multi_tensor_sumsq` read by the kernel from device memory, so the
grads are never rewritten and the host never waits; on the CPU its plain
version, the per-parameter rule. The other optimizers run their rules as
plain torch on any device.

`multi_precision` keeps an fp32 master copy of each bf16/fp16 parameter;
Adam's `moment_dtype` stores m and v in that dtype (updated in fp32),
which is how the 1.9 B-parameter training rung keeps its optimizer state
at 7.5 GB. Updates run in place under `no_grad`: parameters, masters and
Adam's moments are overwritten in their own storage, so the state is
never held twice (the JAX package gets the same from buffer donation).

Parameters are passed as tensors, or as (name, tensor) pairs such as
`model.named_parameters()`, which give `apply_decay_param_fun` its
names. `jit.TrainStep` updates every trainable parameter of its layer
under its `named_parameters()` name, as the JAX `TrainStep` does.
`state_dict()` has the JAX format ({'step', 'slots' in parameter order,
'LR_Scheduler'}), so a JAX optimizer's `state_dict()` loads into its
twin here with `set_state_dict`, cast to the port's dtypes and devices.

`Adam`/`AdamW(offload='host')` keep the slots in pinned host memory and
stream the update through HBM (`optimizer/offload.py`); `state_dict()`
reads the host slots and `set_state_dict()` copies into them.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .. import dtype as _dtype
from ..nn.clip import ClipGradByGlobalNorm
from ..ops import kernels as K
from ..regularizer import L1Decay, L2Decay
from ..weights import _copy_by_name
from . import lr
from .lr import LRScheduler
from .offload import OffloadEngine

_LOW_PRECISION = (torch.bfloat16, torch.float16)
_f32 = np.float32


def _not_ported(what: str):
    return NotImplementedError(f'{what} is not ported yet (ROADMAP.md, '
                               f'Queue 1)')


def _pow(base: float, t) -> np.float32:
    """base ** t in fp32 (the JAX rules' `jnp.power(b, t)`)."""
    return np.power(_f32(base), _f32(t))


class Optimizer:
    """Base optimizer; subclasses implement `_init_slots` and `_rule`."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        self._learning_rate = (learning_rate
                               if isinstance(learning_rate, LRScheduler)
                               else float(learning_rate))
        self._named = self._named_list(parameters)
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        self._decay_mode = 'l2'
        if weight_decay is None:
            self._coeff = 0.0
        elif isinstance(weight_decay, (int, float)):
            self._coeff = float(weight_decay)
        else:
            self._coeff = float(weight_decay._coeff)
            if isinstance(weight_decay, L1Decay):
                self._decay_mode = 'l1'
        self._step_count = 0
        self._slots: Dict[torch.Tensor, dict] = {}

    @staticmethod
    def _named_list(parameters) -> Optional[List[Tuple[Optional[str],
                                                        torch.Tensor]]]:
        if parameters is None:
            return None
        return [item if isinstance(item, tuple) else (None, item)
                for item in parameters]

    def _params(self) -> List[torch.Tensor]:
        if self._named is None:
            raise ValueError('optimizer constructed without parameters')
        return [p for _, p in self._named]

    # -- the per-parameter rule ----------------------------------------
    def _init_slots(self, p: torch.Tensor) -> dict:
        return {}

    def _rule(self, g32, p32, slots, lr, step):
        """(fp32 grad, fp32 param, slots, fp32 lr, step) -> new fp32
        param; replaces or updates the slots it changes."""
        raise NotImplementedError

    def _decoupled_decay(self) -> bool:
        return False

    def _coeff_for(self, name: Optional[str]) -> float:
        return self._coeff

    def _new_slots(self, p: torch.Tensor) -> dict:
        slots = self._init_slots(p)
        if self._multi_precision and p.dtype in _LOW_PRECISION:
            slots['master'] = p.detach().float()
        return slots

    def _slots_for(self, p: torch.Tensor) -> dict:
        slots = self._slots.get(p)
        if slots is None:
            slots = self._slots[p] = self._new_slots(p)
        return slots

    def _prepare_slots(self, params) -> None:
        """Make the slots of `params` that an update would make (an
        offloaded optimizer allocates all of them at once)."""

    def _settle(self) -> None:
        """Wait until every slot is where it is read (the offload
        engine's copies back to the host); nothing to wait for here."""

    def reset_state(self) -> None:
        """Forget the slots and the step count: the state before the
        first update (a rollback to a snapshot taken before it)."""
        self._slots.clear()
        self._step_count = 0

    def _with_grads(self, named, fused_global_clip: bool = False):
        """([(name, param)] with a grad, their grads, clip scale): the
        grads clipped by `grad_clip`, except that with `fused_global_clip`
        a global-norm clip only gives its scale (a 0-d device tensor) for
        the caller to apply."""
        pairs = [(n, p) for n, p in named if p.grad is not None]
        grads = [p.grad for _, p in pairs]
        clip, scale = self._grad_clip, None
        if clip is not None and grads:
            if fused_global_clip and isinstance(clip, ClipGradByGlobalNorm):
                scale = clip.scale(grads)
            else:
                grads = [g for _, g in clip(
                    [(p, g) for (_, p), g in zip(pairs, grads)])]
        return pairs, grads, scale

    @torch.no_grad()
    def update(self, named: Iterable[Tuple[Optional[str], torch.Tensor]]):
        """One update step of every (name, parameter) pair whose grad is
        set (`step()` passes the parameters given at construction,
        `TrainStep` its layer's named trainable parameters)."""
        pairs, grads, _ = self._with_grads(named)
        lr = _f32(self.get_lr())
        self._step_count += 1
        for (name, p), g in zip(pairs, grads):
            slots = self._slots_for(p)
            master = slots.get('master')
            p32 = master if master is not None else p.float()
            g32 = g.float()
            coeff = self._coeff_for(name)
            if coeff and not self._decoupled_decay():
                reg = p32.sign() if self._decay_mode == 'l1' else p32
                g32 = g32 + reg * coeff
            new = self._rule(g32, p32, slots, lr, self._step_count)
            if coeff and self._decoupled_decay():
                new = new - p32 * float(lr * _f32(coeff))
            if master is not None:
                master.copy_(new)
            p.copy_(new)

    # -- the eager API ---------------------------------------------------
    def step(self) -> None:
        """Update every parameter given at construction that has a grad."""
        if self._named is None:
            raise ValueError('optimizer constructed without parameters')
        self.update(self._named)

    def clear_grad(self, set_to_zero=True) -> None:
        """Drop the gradients (set to None, which frees their memory)."""
        for _, p in self._named or ():
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return self._learning_rate

    def set_lr(self, value: float) -> None:
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError('set_lr cannot override an LRScheduler')
        self._learning_rate = float(value)

    # -- state dict ------------------------------------------------------
    def state_dict(self) -> dict:
        """{'step', 'slots': per parameter given at construction, in order,
        None or {slot name: numpy array}, 'LR_Scheduler' under a
        scheduler}: the JAX package's format (bf16 slots as fp32 arrays,
        which hold them exactly)."""
        self._settle()
        out = {'step': self._step_count, 'slots': []}
        for p in self._params():
            s = self._slots.get(p)
            out['slots'].append(None if s is None else {
                k: v.detach().float().cpu().numpy() for k, v in s.items()})
        if isinstance(self._learning_rate, LRScheduler):
            out['LR_Scheduler'] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, sd: dict) -> None:
        """Load a `state_dict()` of this class, here or from the JAX
        package: each parameter's slots (numpy arrays, bf16 ones
        included) are copied, cast to the port's dtypes, into its slots
        where they live (made first where missing: on the parameter's
        device, or the host buffers of an offloaded optimizer); their
        names and shapes must match."""
        self._settle()
        self._step_count = int(sd.get('step', 0))
        self._prepare_slots(self._params())
        for p, s in zip(self._params(), sd.get('slots', [])):
            if s is not None:
                _copy_by_name(s, self._slots_for(p),
                              'optimizer slots do not match')
        if 'LR_Scheduler' in sd and isinstance(self._learning_rate,
                                               LRScheduler):
            self._learning_rate.set_state_dict(sd['LR_Scheduler'])


class SGD(Optimizer):

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)

    def _rule(self, g, p, slots, lr, step):
        return p - g * float(lr)


class Momentum(Optimizer):

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_slots(self, p):
        return {'velocity': torch.zeros(p.shape, device=p.device)}

    def _rule(self, g, p, slots, lr, step):
        v = slots['velocity'] * self._momentum + g
        slots['velocity'] = v
        if self._nesterov:
            return p - (g + v * self._momentum) * float(lr)
        return p - v * float(lr)


class Adagrad(Optimizer):

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_slots(self, p):
        return {'moment': torch.full(p.shape, float(self._init_acc),
                                     device=p.device)}

    def _rule(self, g, p, slots, lr, step):
        m = slots['moment'] + g.square()
        slots['moment'] = m
        return p - (g * float(lr)) / (m.sqrt() + self._epsilon)


class RMSProp(Optimizer):

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_slots(self, p):
        s = {'mean_square': torch.zeros(p.shape, device=p.device),
             'momentum': torch.zeros(p.shape, device=p.device)}
        if self._centered:
            s['mean_grad'] = torch.zeros(p.shape, device=p.device)
        return s

    def _rule(self, g, p, slots, lr, step):
        rho = self._rho
        ms = slots['mean_square'] * rho + g.square() * (1 - rho)
        slots['mean_square'] = ms
        denom = ms
        if self._centered:
            mg = slots['mean_grad'] * rho + g * (1 - rho)
            slots['mean_grad'] = mg
            denom = ms - mg.square()
        upd = g / (denom + self._epsilon).sqrt()
        if self._momentum:
            mom = slots['momentum'] * self._momentum + upd * float(lr)
            slots['momentum'] = mom
            return p - mom
        return p - upd * float(lr)


class Adam(Optimizer):

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 amsgrad=False, moment_dtype=None, offload=None, name=None):
        """moment_dtype: storage dtype of m and v (default fp32); the
        moment update computes in fp32 either way. lazy_mode is accepted
        and ignored, as in the JAX package. offload='host' keeps the
        slots in pinned host memory and streams each update through HBM
        (`optimizer/offload.py`)."""
        if offload not in (None, 'host'):
            raise ValueError(f"offload must be None or 'host', got "
                             f"{offload!r}")
        if offload is not None and type(self) not in (Adam, AdamW):
            raise _not_ported(f'{type(self).__name__}(offload={offload!r})')
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)
        self._amsgrad = bool(amsgrad)
        self._moment_dtype = (_dtype.to_torch_dtype(moment_dtype)
                              if moment_dtype else torch.float32)
        self._engine = OffloadEngine(self) if offload else None

    def _prepare_slots(self, params) -> None:
        if self._engine is not None and not self._engine.initialized:
            self._engine.init(list(params))

    def _settle(self) -> None:
        if self._engine is not None:
            self._engine.settle()

    def reset_state(self) -> None:
        if self._engine is not None and self._engine.initialized:
            self._engine.reset()
            self._step_count = 0
            return
        super().reset_state()

    def _init_slots(self, p):
        names = ('moment1', 'moment2') + (('moment2_max',) if self._amsgrad
                                          else ())
        return {k: torch.zeros(p.shape, dtype=self._moment_dtype,
                               device=p.device) for k in names}

    def _adam_moments(self, g, slots):
        """(m, v) in fp32 from the stored moments, stored back in their
        dtype (NAdam and RAdam share it)."""
        b1, b2 = self._beta1, self._beta2
        m = slots['moment1'].float() * b1 + g * (1 - b1)
        v = slots['moment2'].float() * b2 + g.square() * (1 - b2)
        slots['moment1'] = m.to(self._moment_dtype)
        slots['moment2'] = v.to(self._moment_dtype)
        return m, v

    @torch.no_grad()
    def update(self, named):
        if type(self) not in (Adam, AdamW):     # a rule of its own
            return super().update(named)
        named = list(named)
        self._prepare_slots([p for _, p in named])
        pairs, grads, scale = self._with_grads(named, fused_global_clip=True)
        lr = _f32(self.get_lr())
        self._step_count += 1
        t = self._step_count
        # the step size in fp32, as the JAX package computes it
        lr_t = lr * np.sqrt(_f32(1) - _pow(self._beta2, t)) \
            / (_f32(1) - _pow(self._beta1, t))
        decoupled = self._decoupled_decay()
        decay = []
        for name, _ in pairs:
            coeff = self._coeff_for(name)
            decay.append(float(lr * _f32(coeff)) if decoupled and coeff
                         else coeff)
        if self._engine is not None:
            self._engine.update([p for _, p in pairs], grads, decay,
                                lr_t=float(lr_t),
                                decay_mode='decoupled' if decoupled
                                else self._decay_mode, clip_scale=scale)
            return
        slots = [self._slots_for(p) for _, p in pairs]
        K.multi_tensor_adam(
            [p for _, p in pairs], grads, [s['moment1'] for s in slots],
            [s['moment2'] for s in slots], [s.get('master') for s in slots],
            [s['moment2_max'] for s in slots] if self._amsgrad else None,
            lr_t=float(lr_t), beta1=self._beta1, beta2=self._beta2,
            epsilon=self._epsilon, decay=decay,
            decay_mode='decoupled' if decoupled else self._decay_mode,
            clip_scale=scale)


class AdamW(Adam):
    """Adam with decoupled weight decay (0.01 on every parameter by
    default; `apply_decay_param_fun(name)` False exempts one). lr_ratio
    and lazy_mode are accepted and ignored, as in the JAX package."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 moment_dtype=None, offload=None, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         amsgrad, moment_dtype, offload)
        self._apply_decay_fn = apply_decay_param_fun

    def _decoupled_decay(self):
        return True

    def _coeff_for(self, name):
        if self._apply_decay_fn is not None and name is not None \
                and not self._apply_decay_fn(name):
            return 0.0
        return self._coeff


class Lamb(Optimizer):

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn
        self._lamb_now = lamb_weight_decay

    def _init_slots(self, p):
        return {'moment1': torch.zeros(p.shape, device=p.device),
                'moment2': torch.zeros(p.shape, device=p.device)}

    def _coeff_for(self, name):
        # called once per parameter right before _rule: the exclusion
        # reaches the rule through the decay it leaves here
        self._lamb_now = 0.0 if (
            self._exclude_fn is not None and name is not None
            and self._exclude_fn(name)) else self._lamb_decay
        return 0.0

    def _rule(self, g, p, slots, lr, step):
        b1, b2 = self._beta1, self._beta2
        m = slots['moment1'] * b1 + g * (1 - b1)
        v = slots['moment2'] * b2 + g.square() * (1 - b2)
        slots['moment1'], slots['moment2'] = m, v
        m_hat = m / float(_f32(1) - _pow(b1, step))
        v_hat = v / float(_f32(1) - _pow(b2, step))
        r = m_hat / (v_hat.sqrt() + self._epsilon) + p * self._lamb_now
        w_norm = p.square().sum().sqrt()
        r_norm = r.square().sum().sqrt()
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        return p - r * (trust * float(lr))


class Adadelta(Optimizer):

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._rho, self._epsilon = rho, epsilon

    def _init_slots(self, p):
        return {'avg_squared_grad': torch.zeros(p.shape, device=p.device),
                'avg_squared_update': torch.zeros(p.shape, device=p.device)}

    def _rule(self, g, p, slots, lr, step):
        rho, eps = self._rho, self._epsilon
        sg = slots['avg_squared_grad'] * rho + g.square() * (1 - rho)
        upd = g * (slots['avg_squared_update'] + eps).sqrt() \
            / (sg + eps).sqrt()
        su = slots['avg_squared_update'] * rho + upd.square() * (1 - rho)
        slots['avg_squared_grad'] = sg
        slots['avg_squared_update'] = su
        return p - upd * float(lr)


class Adamax(Optimizer):

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_slots(self, p):
        return {'moment': torch.zeros(p.shape, device=p.device),
                'inf_norm': torch.zeros(p.shape, device=p.device)}

    def _rule(self, g, p, slots, lr, step):
        b1, b2 = self._beta1, self._beta2
        m = slots['moment'] * b1 + g * (1 - b1)
        u = torch.maximum(slots['inf_norm'] * b2, g.abs())
        slots['moment'], slots['inf_norm'] = m, u
        step_size = lr / (_f32(1) - _pow(b1, step))
        return p - (m * float(step_size)) / (u + self._epsilon)


class NAdam(Adam):
    """Adam with Nesterov momentum and the Dozat momentum-decay schedule
    mu_t = beta1 * (1 - 0.5 * 0.96^(t * psi)); the running mu product is a
    0-d fp32 slot per parameter, kept on its device."""

    def __init__(self, *args, momentum_decay=0.004, **kwargs):
        super().__init__(*args, **kwargs)
        self._momentum_decay = momentum_decay

    def _init_slots(self, p):
        s = super()._init_slots(p)
        s['mu_product'] = torch.ones((), device=p.device)
        return s

    def _rule(self, g, p, slots, lr, step):
        m, v = self._adam_moments(g, slots)
        t, psi = _f32(step), _f32(self._momentum_decay)
        b1 = _f32(self._beta1)
        mu_t = b1 * (_f32(1) - _f32(0.5) * _pow(0.96, t * psi))
        mu_t1 = b1 * (_f32(1) - _f32(0.5) * _pow(0.96, (t + _f32(1)) * psi))
        mu_prod = slots['mu_product'] * float(mu_t)
        slots['mu_product'] = mu_prod
        m_hat = (m * float(mu_t1)) / (1 - mu_prod * float(mu_t1)) \
            + (g * float(_f32(1) - mu_t)) / (1 - mu_prod)
        v_hat = v / float(_f32(1) - _pow(self._beta2, t))
        return p - (m_hat * float(lr)) / (v_hat.sqrt() + self._epsilon)


class RAdam(Adam):
    """Rectified Adam: unadapted momentum SGD while the variance rectifier
    is untrustworthy (rho_t <= 5, as torch and Paddle have it); rho_t is
    a host scalar, so only the branch taken is computed."""

    def _rule(self, g, p, slots, lr, step):
        m, v = self._adam_moments(g, slots)
        b2, t = self._beta2, _f32(step)
        rho_inf = 2.0 / (1 - b2) - 1
        b2t = _pow(b2, t)
        rho_t = _f32(rho_inf) - _f32(2) * t * b2t / (_f32(1) - b2t)
        m_hat = m / float(_f32(1) - _pow(self._beta1, t))
        if not rho_t > 5.0:
            return p - m_hat * float(lr)
        r = np.sqrt(np.maximum(
            (rho_t - _f32(4)) * (rho_t - _f32(2)) * _f32(rho_inf)
            / np.maximum(_f32((rho_inf - 4) * (rho_inf - 2)) * rho_t,
                         _f32(1e-9)), _f32(0)))
        return p - (m_hat * float(lr * r) * float(np.sqrt(_f32(1) - b2t))) \
            / (v.sqrt() + self._epsilon)


class Rprop(Optimizer):
    """Resilient backprop: per-weight step sizes grown or shrunk by the
    agreement of the gradient's sign with the last one's."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision)
        self._eta_minus, self._eta_plus = etas
        self._lr_min, self._lr_max = learning_rate_range
        try:
            self._lr0 = float(learning_rate)
        except (TypeError, ValueError):
            self._lr0 = 1e-2    # scheduler-driven: seed step sizes modestly

    def _init_slots(self, p):
        return {'prev_grad': torch.zeros(p.shape, device=p.device),
                'step_size': torch.full(p.shape, self._lr0, device=p.device)}

    def _rule(self, g, p, slots, lr, step):
        sign = (g * slots['prev_grad']).sign()
        factor = torch.where(sign > 0, self._eta_plus,
                             torch.where(sign < 0, self._eta_minus, 1.0))
        size = (slots['step_size'] * factor).clamp(self._lr_min, self._lr_max)
        # on a sign flip, skip the update and forget the grad
        g_eff = torch.where(sign < 0, 0.0, g)
        slots['prev_grad'], slots['step_size'] = g_eff, size
        return p - size * g_eff.sign()


class ASGD(Optimizer):
    """Averaged SGD: steps with the mean of the last `batch_num` grads,
    kept in a [batch_num, *shape] ring buffer per parameter."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._batch_num = max(int(batch_num), 1)

    def _init_slots(self, p):
        if self._batch_num == 1:
            return {}
        return {'grad_ring': torch.zeros((self._batch_num,) + tuple(p.shape),
                                         device=p.device),
                'grad_sum': torch.zeros(p.shape, device=p.device)}

    def _rule(self, g, p, slots, lr, step):
        n = self._batch_num
        if n == 1:
            return p - g * float(lr)
        ring = slots['grad_ring']
        idx = (step - 1) % n
        ssum = slots['grad_sum'] - ring[idx] + g
        ring[idx] = g
        slots['grad_sum'] = ssum
        return p - (ssum * float(lr)) / float(min(step, n))


__all__ = ['ASGD', 'Adadelta', 'Adagrad', 'Adam', 'Adamax', 'AdamW',
           'L1Decay', 'L2Decay', 'Lamb', 'Momentum', 'NAdam', 'Optimizer',
           'RAdam', 'RMSProp', 'Rprop', 'SGD', 'lr']
