"""LR schedulers (counterpart of `paddle_tpu/optimizer/lr.py`).

A copy of the JAX package's schedulers, which are plain Python: the
same 20 step()-driven schedulers with the same state_dict format, so a
JAX scheduler's `state_dict()` loads into its twin here. The optimizer
reads `scheduler()` on the host at every update; the caller steps the
scheduler.
"""
from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = self.base_lr
        self.step()

    def get_lr(self):
        raise NotImplementedError

    def step(self, epoch=None):
        self.last_epoch = self.last_epoch + 1 if epoch is None else epoch
        self.last_lr = float(self.get_lr())

    def __call__(self):
        return self.last_lr

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()
                if isinstance(v, (int, float, bool, str, list))}

    def set_state_dict(self, sd):
        self.__dict__.update(sd)

    def get_last_lr(self):
        return self.last_lr


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(1, self.last_epoch)
        return (self.base_lr * self.d_model ** -0.5
                * min(step ** -0.5, step * self.warmup_steps ** -1.5))


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        if self.cycle:
            div = math.ceil(max(step, 1) / self.decay_steps)
            decay_steps = self.decay_steps * max(div, 1)
        else:
            decay_steps = self.decay_steps
            step = min(step, decay_steps)
        frac = (1 - step / decay_steps) ** self.power
        return (self.base_lr - self.end_lr) * frac + self.end_lr


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma ** n


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)

    def state_dict(self):
        d = super().state_dict()
        d.pop('lr_lambda', None)
        return d


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0.0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return (self.eta_min + (self.base_lr - self.eta_min)
                * (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2)


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_after = learning_rate  # float or LRScheduler
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(end_lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * (
                self.last_epoch / self.warmup_steps) + self.start_lr
        if isinstance(self.lr_after, LRScheduler):
            return self.lr_after()
        return self.lr_after

    def step(self, epoch=None):
        if self.last_epoch >= self.warmup_steps \
                and isinstance(self.lr_after, LRScheduler):
            self.lr_after.step(epoch)
        super().step(epoch)

    def state_dict(self):
        d = super().state_dict()
        if isinstance(self.lr_after, LRScheduler):
            d['lr_after'] = self.lr_after.state_dict()
        return d

    def set_state_dict(self, sd):
        sub = sd.pop('lr_after', None)
        self.__dict__.update(sd)
        if sub is not None and isinstance(self.lr_after, LRScheduler):
            self.lr_after.set_state_dict(sub)


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy='cos', last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _interp(self, a, b, pct):
        if self.anneal == 'cos':
            return b + (a - b) * (1 + math.cos(math.pi * pct)) / 2
        return a + (b - a) * pct

    def get_lr(self):
        step = min(self.last_epoch, self.total_steps)
        up = self.phase_pct * self.total_steps
        if step <= up:
            return self._interp(self.initial_lr, self.max_lr,
                                step / max(up, 1))
        pct = (step - up) / max(self.total_steps - up, 1)
        return self._interp(self.max_lr, self.end_lr, pct)


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate,
                 step_size_up=2000, step_size_down=None, mode='triangular',
                 exp_gamma=1.0, last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.up = step_size_up
        self.down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        cycle_len = self.up + self.down
        pos = self.last_epoch % cycle_len
        frac = pos / self.up if pos < self.up else \
            1 - (pos - self.up) / self.down
        amp = self.max_lr - self.base_lr
        if self.mode == 'triangular2':
            amp = amp / (2 ** (self.last_epoch // cycle_len))
        elif self.mode == 'exp_range':
            amp = amp * self.exp_gamma ** self.last_epoch
        return self.base_lr + amp * frac


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode='min', factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode='rel', cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self.base_lr = float(learning_rate)
        self.last_lr = self.base_lr
        self.last_epoch = 0

    def get_lr(self):
        return self.last_lr

    def _better(self, a, b):
        if b is None:
            return True
        if self.threshold_mode == 'rel':
            eps = 1.0 - self.threshold if self.mode == 'min' \
                else 1.0 + self.threshold
            return a < b * eps if self.mode == 'min' else a > b * eps
        return a < b - self.threshold if self.mode == 'min' \
            else a > b + self.threshold

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        m = float(metrics)
        self.last_epoch += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self._better(m, self.best):
            self.best = m
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.last_lr = max(self.last_lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0


class CosineAnnealingWarmRestarts(LRScheduler):
    """SGDR (upstream: lr.py CosineAnnealingWarmRestarts): cosine decay
    restarting every T_i epochs, periods growing by T_mult."""

    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0.0,
                 last_epoch=-1, verbose=False):
        if T_0 <= 0 or T_mult < 1:
            raise ValueError('T_0 must be > 0 and T_mult >= 1')
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t = max(self.last_epoch, 0)
        T_i, t_cur = self.T_0, t
        while t_cur >= T_i:
            t_cur -= T_i
            T_i *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) \
            * (1 + math.cos(math.pi * t_cur / T_i)) / 2


class MultiplicativeDecay(LRScheduler):
    """lr *= lr_lambda(epoch) each step (upstream
    paddle.optimizer.lr.MultiplicativeDecay). The factor applies
    cumulatively from epoch 1; the running product is tracked
    incrementally (O(1) per sequential step) and only rebuilt on epoch
    jumps (set_state_dict / explicit step(epoch))."""

    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        self._prod = 1.0
        self._prod_epoch = 0
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch == self._prod_epoch + 1:
            self._prod *= self.lr_lambda(self.last_epoch)
        elif self.last_epoch != self._prod_epoch:
            self._prod = 1.0
            for e in range(1, self.last_epoch + 1):
                self._prod *= self.lr_lambda(e)
        self._prod_epoch = self.last_epoch
        return self.base_lr * self._prod


class LinearLR(LRScheduler):
    """Linear ramp of the LR factor from start_factor to end_factor over
    total_steps (upstream paddle.optimizer.lr.LinearLR)."""

    def __init__(self, learning_rate, total_steps, start_factor=1.0 / 3,
                 end_factor=1.0, last_epoch=-1, verbose=False):
        if total_steps <= 0:
            raise ValueError('total_steps must be positive')
        self.total_steps = total_steps
        self.start_factor = start_factor
        self.end_factor = end_factor
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t = min(self.last_epoch, self.total_steps)
        frac = t / self.total_steps
        factor = self.start_factor + \
            (self.end_factor - self.start_factor) * frac
        return self.base_lr * factor
