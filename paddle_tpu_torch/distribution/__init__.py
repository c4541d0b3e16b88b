"""paddle.distribution (counterpart of `paddle_tpu/distribution/`;
upstream: python/paddle/distribution/): the distribution zoo with
sample/rsample/log_prob/entropy/mean/variance, a `register_kl`
pair-dispatch registry, Independent/TransformedDistribution wrappers,
and invertible transforms.

Every density and statistic is a torch function written after the JAX
package's formula (`torch.special` for lgamma, digamma, xlogy), recorded
on the tape through `tensor.apply_op`, so log_prob is differentiable;
`torch.distributions` is not used (its parameter checks, broadcasting
and rounding order differ). Parameters that are not Tensors become
float32 Tensors on the current place. Sampling draws on the parameters'
device from a `torch.Generator`: `seed=0` from the framework's default
generator of that device (`framework.default_generator`, reseeded by
`paddle.seed`), another seed from a fresh generator seeded with it, so
one seed gives the same draws twice. The two packages draw from
different streams: samples agree in distribution, not bit for bit.
`rsample` is reparameterized wherever upstream has it; Gamma, Beta and
Dirichlet take implicit-reparameterization gradients through
`torch._standard_gamma` (Beta a ratio of two gammas, Dirichlet a
normalized vector of gammas), as `jax.random.gamma` has them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF
from torch.special import digamma, gammaln, xlogy

from .. import framework
from ..tensor import apply_op, to_torch
from .transform import (Transform, AffineTransform, ExpTransform,
                        SigmoidTransform, TanhTransform, PowerTransform,
                        AbsTransform, ChainTransform, _as_t)

__all__ = [
    'Distribution', 'Normal', 'Uniform', 'Categorical', 'Bernoulli',
    'Beta', 'Dirichlet', 'Gamma', 'Exponential', 'Geometric', 'Gumbel',
    'Laplace', 'LogNormal', 'Multinomial', 'Poisson', 'StudentT',
    'Independent', 'TransformedDistribution', 'kl_divergence',
    'register_kl', 'Transform', 'AffineTransform', 'ExpTransform',
    'SigmoidTransform', 'TanhTransform', 'PowerTransform', 'AbsTransform',
    'ChainTransform',
]

_EULER = 0.5772156649015329  # Euler–Mascheroni
_TINY = torch.finfo(torch.float32).tiny


def _gen(seed, device) -> torch.Generator:
    """The generator a draw on `device` takes: the framework's default
    one for seed 0, else a fresh one seeded with `seed`."""
    if not seed:
        return framework.default_generator(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _uniform(shape, g, device, minval=0.0, maxval=1.0):
    """float32 uniform draws in [minval, maxval)."""
    u = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
    return minval + (maxval - minval) * u


def _normal(shape, g, device):
    return torch.randn(shape, generator=g, device=device,
                       dtype=torch.float32)


def _gamma(conc: torch.Tensor, shape, g) -> torch.Tensor:
    """Standard gamma draws of `shape` at concentration `conc` (broadcast),
    differentiable in `conc` (implicit reparameterization)."""
    return torch._standard_gamma(conc.expand(shape).contiguous(),
                                 generator=g)


def _beta(a: torch.Tensor, b: torch.Tensor, shape, g) -> torch.Tensor:
    """Beta draws as the ratio of two gamma draws (a's, then b's)."""
    ga = _gamma(a, shape, g)
    gb = _gamma(b, shape, g)
    return ga / (ga + gb)


def _gumbel(shape, g, device):
    return -torch.log(-torch.log(_uniform(shape, g, device, minval=_TINY)))


def _categorical(logits: torch.Tensor, shape, g) -> torch.Tensor:
    """Gumbel-max draws over the last axis of `logits`, of
    `shape` (which ends with logits' batch shape)."""
    gum = _gumbel(tuple(shape) + logits.shape[-1:], g, logits.device)
    return torch.argmax(logits + gum, dim=-1)


def _bshape(*ts):
    return torch.broadcast_shapes(*(t.shape for t in ts))


class Distribution:
    def sample(self, shape=()):
        raise NotImplementedError

    def rsample(self, shape=()):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def prob(self, value):
        return apply_op(torch.exp, self.log_prob(value), _name='exp')


class Normal(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc = _as_t(loc)
        self.scale = _as_t(scale)

    @property
    def mean(self):
        return self.loc

    @property
    def variance(self):
        return self.scale * self.scale

    def sample(self, shape=(), seed=0):
        shape = tuple(shape)

        def f(loc, scale):
            eps = _normal(shape + _bshape(loc, scale),
                          _gen(seed, loc.device), loc.device)
            return loc + scale * eps
        return apply_op(f, self.loc, self.scale, _name='normal_sample')

    rsample = sample  # reparameterized by construction

    def log_prob(self, value):
        def f(v, loc, scale):
            var = scale * scale
            return -((v - loc) ** 2) / (2 * var) - torch.log(scale) \
                - 0.5 * math.log(2 * math.pi)
        return apply_op(f, _as_t(value), self.loc, self.scale,
                        _name='normal_log_prob')

    def entropy(self):
        return apply_op(
            lambda s: 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(s),
            self.scale, _name='normal_entropy')

    def kl_divergence(self, other: 'Normal'):
        return kl_divergence(self, other)


class Uniform(Distribution):
    def __init__(self, low, high, name=None):
        self.low = _as_t(low)
        self.high = _as_t(high)

    @property
    def mean(self):
        return apply_op(lambda lo, hi: (lo + hi) / 2, self.low, self.high,
                        _name='uniform_mean')

    @property
    def variance(self):
        return apply_op(lambda lo, hi: (hi - lo) ** 2 / 12.0, self.low,
                        self.high, _name='uniform_var')

    def sample(self, shape=(), seed=0):
        shape = tuple(shape)

        def f(lo, hi):
            u = _uniform(shape + _bshape(lo, hi), _gen(seed, lo.device),
                         lo.device)
            return lo + (hi - lo) * u
        return apply_op(f, self.low, self.high, _name='uniform_sample')

    rsample = sample

    def log_prob(self, value):
        def f(v, lo, hi):
            inside = (v >= lo) & (v < hi)
            return torch.where(inside, -torch.log(hi - lo), -math.inf)
        return apply_op(f, _as_t(value), self.low, self.high,
                        _name='uniform_log_prob')

    def entropy(self):
        return apply_op(lambda lo, hi: torch.log(hi - lo), self.low,
                        self.high, _name='uniform_entropy')


class Categorical(Distribution):
    def __init__(self, logits, name=None):
        self.logits = _as_t(logits)

    def sample(self, shape=(), seed=0):
        shape = tuple(shape)
        return apply_op(
            lambda lg: _categorical(lg, shape + lg.shape[:-1],
                                    _gen(seed, lg.device)),
            self.logits, _name='categorical_sample')

    def probs(self, value=None):
        p = apply_op(lambda lg: torch.softmax(lg, dim=-1), self.logits,
                     _name='softmax')
        if value is None:
            return p
        return apply_op(
            lambda pv, idx: torch.gather(
                pv.expand(idx.shape + pv.shape[-1:]), -1,
                idx.long()[..., None])[..., 0],
            p, _as_t(value), _name='categorical_probs')

    def log_prob(self, value):
        def f(lg, idx):
            logp = torch.log_softmax(lg, dim=-1)
            idx = idx.long().reshape(lg.shape[:-1])
            return torch.gather(logp, -1, idx[..., None])[..., 0]
        return apply_op(f, self.logits, _as_t(value),
                        _name='categorical_log_prob')

    def entropy(self):
        def f(lg):
            logp = torch.log_softmax(lg, dim=-1)
            return -torch.sum(torch.exp(logp) * logp, dim=-1)
        return apply_op(f, self.logits, _name='categorical_entropy')

    def kl_divergence(self, other: 'Categorical'):
        return kl_divergence(self, other)


class Bernoulli(Distribution):
    def __init__(self, probs, name=None):
        self.probs = _as_t(probs)

    @property
    def mean(self):
        return self.probs

    @property
    def variance(self):
        return apply_op(lambda p: p * (1 - p), self.probs,
                        _name='bernoulli_var')

    def sample(self, shape=(), seed=0):
        shape = tuple(shape)
        return apply_op(
            lambda p: (_uniform(shape + p.shape, _gen(seed, p.device),
                                p.device) < p).to(torch.float32),
            self.probs, _name='bernoulli_sample')

    def log_prob(self, value):
        def f(p, v):
            p = torch.clamp(p, 1e-7, 1 - 1e-7)
            return v * torch.log(p) + (1 - v) * torch.log1p(-p)
        return apply_op(f, self.probs, _as_t(value),
                        _name='bernoulli_log_prob')

    def entropy(self):
        def f(p):
            p = torch.clamp(p, 1e-7, 1 - 1e-7)
            return -(p * torch.log(p) + (1 - p) * torch.log1p(-p))
        return apply_op(f, self.probs, _name='bernoulli_entropy')


def _logbeta(a, b):
    return gammaln(a) + gammaln(b) - gammaln(a + b)


class Beta(Distribution):
    """Beta(alpha, beta) on (0, 1) (upstream distribution/beta.py)."""

    def __init__(self, alpha, beta, name=None):
        self.alpha = _as_t(alpha)
        self.beta = _as_t(beta)

    @property
    def mean(self):
        return apply_op(lambda a, b: a / (a + b), self.alpha, self.beta,
                        _name='beta_mean')

    @property
    def variance(self):
        return apply_op(
            lambda a, b: a * b / ((a + b) ** 2 * (a + b + 1)),
            self.alpha, self.beta, _name='beta_var')

    def rsample(self, shape=(), seed=0):
        shape = tuple(shape)

        def f(a, b):
            return _beta(a, b, shape + _bshape(a, b), _gen(seed, a.device))
        return apply_op(f, self.alpha, self.beta, _name='beta_sample')

    sample = rsample

    def log_prob(self, value):
        def f(v, a, b):
            return ((a - 1) * torch.log(v) + (b - 1) * torch.log1p(-v)
                    - _logbeta(a, b))
        return apply_op(f, _as_t(value), self.alpha, self.beta,
                        _name='beta_log_prob')

    def entropy(self):
        def f(a, b):
            return (_logbeta(a, b) - (a - 1) * digamma(a)
                    - (b - 1) * digamma(b)
                    + (a + b - 2) * digamma(a + b))
        return apply_op(f, self.alpha, self.beta, _name='beta_entropy')


class Dirichlet(Distribution):
    """Dirichlet(concentration) on the simplex (upstream
    distribution/dirichlet.py)."""

    def __init__(self, concentration, name=None):
        self.concentration = _as_t(concentration)

    @property
    def mean(self):
        return apply_op(lambda c: c / torch.sum(c, -1, keepdim=True),
                        self.concentration, _name='dirichlet_mean')

    @property
    def variance(self):
        def f(c):
            c0 = torch.sum(c, -1, keepdim=True)
            m = c / c0
            return m * (1 - m) / (c0 + 1)
        return apply_op(f, self.concentration, _name='dirichlet_var')

    def rsample(self, shape=(), seed=0):
        shape = tuple(shape)

        def f(c):
            # gamma-normalization keeps implicit-reparameterization grads
            g = _gamma(c, shape + c.shape, _gen(seed, c.device))
            return g / torch.sum(g, dim=-1, keepdim=True)
        return apply_op(f, self.concentration, _name='dirichlet_sample')

    sample = rsample

    def log_prob(self, value):
        def f(v, c):
            logbeta = (torch.sum(gammaln(c), -1)
                       - gammaln(torch.sum(c, -1)))
            return torch.sum((c - 1) * torch.log(v), -1) - logbeta
        return apply_op(f, _as_t(value), self.concentration,
                        _name='dirichlet_log_prob')

    def entropy(self):
        def f(c):
            c0 = torch.sum(c, -1)
            kdim = c.shape[-1]
            logbeta = torch.sum(gammaln(c), -1) - gammaln(c0)
            return (logbeta + (c0 - kdim) * digamma(c0)
                    - torch.sum((c - 1) * digamma(c), -1))
        return apply_op(f, self.concentration, _name='dirichlet_entropy')


class Gamma(Distribution):
    """Gamma(concentration k, rate β) (upstream distribution/gamma.py)."""

    def __init__(self, concentration, rate, name=None):
        self.concentration = _as_t(concentration)
        self.rate = _as_t(rate)

    @property
    def mean(self):
        return apply_op(lambda a, b: a / b, self.concentration, self.rate,
                        _name='gamma_mean')

    @property
    def variance(self):
        return apply_op(lambda a, b: a / (b * b), self.concentration,
                        self.rate, _name='gamma_var')

    def rsample(self, shape=(), seed=0):
        shape = tuple(shape)

        def f(a, b):
            return _gamma(a, shape + _bshape(a, b),
                          _gen(seed, a.device)) / b
        return apply_op(f, self.concentration, self.rate,
                        _name='gamma_sample')

    sample = rsample

    def log_prob(self, value):
        def f(v, a, b):
            return (a * torch.log(b) + (a - 1) * torch.log(v) - b * v
                    - gammaln(a))
        return apply_op(f, _as_t(value), self.concentration, self.rate,
                        _name='gamma_log_prob')

    def entropy(self):
        def f(a, b):
            return (a - torch.log(b) + gammaln(a)
                    + (1 - a) * digamma(a))
        return apply_op(f, self.concentration, self.rate,
                        _name='gamma_entropy')


class Exponential(Distribution):
    """Exponential(rate) (upstream distribution/exponential.py)."""

    def __init__(self, rate, name=None):
        self.rate = _as_t(rate)

    @property
    def mean(self):
        return apply_op(lambda r: 1.0 / r, self.rate, _name='exp_mean')

    @property
    def variance(self):
        return apply_op(lambda r: 1.0 / (r * r), self.rate,
                        _name='exp_var')

    def rsample(self, shape=(), seed=0):
        shape = tuple(shape)

        def f(r):
            u = _uniform(shape + r.shape, _gen(seed, r.device), r.device,
                         minval=_TINY)
            return -torch.log(u) / r
        return apply_op(f, self.rate, _name='exponential_sample')

    sample = rsample

    def log_prob(self, value):
        return apply_op(lambda v, r: torch.log(r) - r * v, _as_t(value),
                        self.rate, _name='exponential_log_prob')

    def entropy(self):
        return apply_op(lambda r: 1.0 - torch.log(r), self.rate,
                        _name='exponential_entropy')


class Geometric(Distribution):
    """Geometric(probs): failures before the first success, support
    {0, 1, 2, ...}, pmf(k) = (1-p)^k p (upstream
    distribution/geometric.py; same convention as torch/scipy-shifted)."""

    def __init__(self, probs, name=None):
        self.probs = _as_t(probs)

    @property
    def mean(self):
        return apply_op(lambda p: (1 - p) / p, self.probs,
                        _name='geometric_mean')

    @property
    def variance(self):
        return apply_op(lambda p: (1 - p) / (p * p), self.probs,
                        _name='geometric_var')

    def sample(self, shape=(), seed=0):
        shape = tuple(shape)

        def f(p):
            u = _uniform(shape + p.shape, _gen(seed, p.device), p.device,
                         minval=_TINY)
            return torch.floor(torch.log(u) / torch.log1p(-p))
        return apply_op(f, self.probs, _name='geometric_sample')

    def log_prob(self, value):
        return apply_op(
            lambda v, p: v * torch.log1p(-p) + torch.log(p), _as_t(value),
            self.probs, _name='geometric_log_prob')

    def entropy(self):
        def f(p):
            q = 1 - p
            return -(q * torch.log(q) + p * torch.log(p)) / p
        return apply_op(f, self.probs, _name='geometric_entropy')


class Gumbel(Distribution):
    """Gumbel(loc, scale) (upstream distribution/gumbel.py)."""

    def __init__(self, loc, scale, name=None):
        self.loc = _as_t(loc)
        self.scale = _as_t(scale)

    @property
    def mean(self):
        return apply_op(lambda l, s: l + _EULER * s, self.loc, self.scale,
                        _name='gumbel_mean')

    @property
    def variance(self):
        return apply_op(lambda l, s: (math.pi ** 2 / 6.0) * s * s,
                        self.loc, self.scale, _name='gumbel_var')

    def rsample(self, shape=(), seed=0):
        shape = tuple(shape)

        def f(l, s):
            g = _gumbel(shape + _bshape(l, s), _gen(seed, l.device),
                        l.device)
            return l + s * g
        return apply_op(f, self.loc, self.scale, _name='gumbel_sample')

    sample = rsample

    def log_prob(self, value):
        def f(v, l, s):
            z = (v - l) / s
            return -(z + torch.exp(-z)) - torch.log(s)
        return apply_op(f, _as_t(value), self.loc, self.scale,
                        _name='gumbel_log_prob')

    def entropy(self):
        return apply_op(lambda l, s: torch.log(s) + 1.0 + _EULER, self.loc,
                        self.scale, _name='gumbel_entropy')


class Laplace(Distribution):
    """Laplace(loc, scale) (upstream distribution/laplace.py)."""

    def __init__(self, loc, scale, name=None):
        self.loc = _as_t(loc)
        self.scale = _as_t(scale)

    @property
    def mean(self):
        return self.loc

    @property
    def variance(self):
        return apply_op(lambda s: 2.0 * s * s, self.scale,
                        _name='laplace_var')

    def rsample(self, shape=(), seed=0):
        shape = tuple(shape)

        def f(l, s):
            u = _uniform(shape + _bshape(l, s), _gen(seed, l.device),
                         l.device, minval=-0.5 + 1e-7, maxval=0.5)
            return l - s * torch.sign(u) * torch.log1p(-2 * torch.abs(u))
        return apply_op(f, self.loc, self.scale, _name='laplace_sample')

    sample = rsample

    def log_prob(self, value):
        def f(v, l, s):
            return -torch.abs(v - l) / s - torch.log(2 * s)
        return apply_op(f, _as_t(value), self.loc, self.scale,
                        _name='laplace_log_prob')

    def entropy(self):
        return apply_op(lambda s: 1.0 + torch.log(2 * s), self.scale,
                        _name='laplace_entropy')


class LogNormal(Distribution):
    """LogNormal(loc, scale): exp of a Normal (upstream
    distribution/lognormal.py)."""

    def __init__(self, loc, scale, name=None):
        self.loc = _as_t(loc)
        self.scale = _as_t(scale)
        self._base = Normal(self.loc, self.scale)

    @property
    def mean(self):
        return apply_op(lambda l, s: torch.exp(l + s * s / 2), self.loc,
                        self.scale, _name='lognormal_mean')

    @property
    def variance(self):
        return apply_op(
            lambda l, s: (torch.exp(s * s) - 1) * torch.exp(2 * l + s * s),
            self.loc, self.scale, _name='lognormal_var')

    def rsample(self, shape=(), seed=0):
        z = self._base.rsample(shape, seed)
        return apply_op(torch.exp, z, _name='lognormal_sample')

    sample = rsample

    def log_prob(self, value):
        def f(v, l, s):
            logv = torch.log(v)
            return (-((logv - l) ** 2) / (2 * s * s) - torch.log(s)
                    - 0.5 * math.log(2 * math.pi) - logv)
        return apply_op(f, _as_t(value), self.loc, self.scale,
                        _name='lognormal_log_prob')

    def entropy(self):
        # base normal entropy + E[log x] = loc
        return apply_op(
            lambda l, s: 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(s)
            + l, self.loc, self.scale, _name='lognormal_entropy')


class Multinomial(Distribution):
    """Multinomial(total_count, probs) (upstream
    distribution/multinomial.py). total_count is a python int."""

    def __init__(self, total_count, probs, name=None):
        self.total_count = int(total_count)
        self.probs = _as_t(probs)

    @property
    def mean(self):
        n = self.total_count
        return apply_op(lambda p: n * p, self.probs,
                        _name='multinomial_mean')

    @property
    def variance(self):
        n = self.total_count
        return apply_op(lambda p: n * p * (1 - p), self.probs,
                        _name='multinomial_var')

    def sample(self, shape=(), seed=0):
        shape = tuple(shape)
        n = self.total_count

        def f(p):
            kdim = p.shape[-1]
            # n categorical draws -> one-hot counts; [n, shape..., batch]
            draws = _categorical(torch.log(p), (n,) + shape + p.shape[:-1],
                                 _gen(seed, p.device))
            return torch.sum(TF.one_hot(draws, kdim).to(torch.float32),
                             dim=0)
        return apply_op(f, self.probs, _name='multinomial_sample')

    def log_prob(self, value):
        def f(v, p):
            # xlogy: 0 * log(0) = 0 for zero-prob categories with 0 count
            return (gammaln(torch.sum(v, -1) + 1)
                    - torch.sum(gammaln(v + 1), -1)
                    + torch.sum(xlogy(v, p), -1))
        return apply_op(f, _as_t(value), self.probs,
                        _name='multinomial_log_prob')


class Poisson(Distribution):
    """Poisson(rate) (upstream distribution/poisson.py)."""

    def __init__(self, rate, name=None):
        self.rate = _as_t(rate)

    @property
    def mean(self):
        return self.rate

    @property
    def variance(self):
        return self.rate

    def sample(self, shape=(), seed=0):
        shape = tuple(shape)
        return apply_op(
            lambda r: torch.poisson(r.expand(shape + r.shape).contiguous(),
                                    generator=_gen(seed, r.device)),
            self.rate, _name='poisson_sample')

    def log_prob(self, value):
        return apply_op(
            lambda v, r: v * torch.log(r) - r - gammaln(v + 1),
            _as_t(value), self.rate, _name='poisson_log_prob')

    def entropy(self):
        """Truncated-series entropy -Σ pmf·log pmf over k ≤ rate+10σ+10
        (the same bounded-support evaluation upstream uses; reads the
        largest rate on the host)."""
        rmax = float(torch.max(to_torch(self.rate)))
        upper = int(rmax + 10.0 * math.sqrt(max(rmax, 1.0)) + 10)

        def f(r):
            ks = torch.arange(upper + 1, dtype=torch.float32,
                              device=r.device)
            ks = ks.reshape((upper + 1,) + (1,) * r.dim())
            logp = ks * torch.log(r) - r - gammaln(ks + 1)
            return -torch.sum(torch.exp(logp) * logp, dim=0)
        return apply_op(f, self.rate, _name='poisson_entropy')


class StudentT(Distribution):
    """StudentT(df, loc, scale) (upstream distribution/student_t.py)."""

    def __init__(self, df, loc=0.0, scale=1.0, name=None):
        self.df = _as_t(df)
        self.loc = _as_t(loc)
        self.scale = _as_t(scale)

    @property
    def mean(self):
        return self.loc

    @property
    def variance(self):
        def f(df, s):
            return torch.where(df > 2, s * s * df / (df - 2), math.inf)
        return apply_op(f, self.df, self.scale, _name='studentt_var')

    def rsample(self, shape=(), seed=0):
        shape = tuple(shape)

        def f(df, l, s):
            full = shape + _bshape(df, l, s)
            g = _gen(seed, df.device)
            # t = z * sqrt((df/2) / Gamma(df/2)), jax.random.t's form
            z = _normal(full, g, df.device)
            half = df / 2
            t = z * torch.sqrt(half / _gamma(half, full, g))
            return l + s * t
        return apply_op(f, self.df, self.loc, self.scale,
                        _name='studentt_sample')

    sample = rsample

    def log_prob(self, value):
        def f(v, df, l, s):
            z = (v - l) / s
            return (gammaln((df + 1) / 2) - gammaln(df / 2)
                    - 0.5 * torch.log(df * math.pi) - torch.log(s)
                    - (df + 1) / 2 * torch.log1p(z * z / df))
        return apply_op(f, _as_t(value), self.df, self.loc, self.scale,
                        _name='studentt_log_prob')

    def entropy(self):
        def f(df, s):
            half = (df + 1) / 2
            logbeta = (gammaln(df / 2) + math.lgamma(0.5)
                       - gammaln(df / 2 + 0.5))  # log B(df/2, 1/2)
            return (half * (digamma(half) - digamma(df / 2))
                    + 0.5 * torch.log(df) + logbeta + torch.log(s))
        return apply_op(f, self.df, self.scale, _name='studentt_entropy')


class Independent(Distribution):
    """Reinterpret the last `reinterpreted_batch_ndims` batch dims of a
    base distribution as event dims (upstream
    distribution/independent.py): log_prob/entropy sum over them."""

    def __init__(self, base, reinterpreted_batch_ndims=1, name=None):
        self.base = base
        self.reinterpreted_batch_ndims = int(reinterpreted_batch_ndims)

    def _sum_event(self, t):
        n = self.reinterpreted_batch_ndims
        if n == 0:
            return t
        return apply_op(
            lambda v: torch.sum(v, dim=tuple(range(v.dim() - n, v.dim()))),
            t, _name='independent_sum')

    def sample(self, shape=(), seed=0):
        return self.base.sample(shape, seed)

    def rsample(self, shape=(), seed=0):
        return self.base.rsample(shape, seed)

    def log_prob(self, value):
        return self._sum_event(self.base.log_prob(value))

    def entropy(self):
        return self._sum_event(self.base.entropy())

    @property
    def mean(self):
        return self.base.mean

    @property
    def variance(self):
        return self.base.variance


class TransformedDistribution(Distribution):
    """Push a base distribution through invertible transforms (upstream
    distribution/transformed_distribution.py)."""

    def __init__(self, base, transforms, name=None):
        self.base = base
        self.transforms = [transforms] if isinstance(transforms, Transform) \
            else list(transforms)

    def _fwd(self, x):
        for t in self.transforms:
            x = t.forward(x)
        return x

    def sample(self, shape=(), seed=0):
        return self._fwd(self.base.sample(shape, seed))

    def rsample(self, shape=(), seed=0):
        return self._fwd(self.base.rsample(shape, seed))

    def log_prob(self, value):
        y = _as_t(value)
        lp = None
        for t in reversed(self.transforms):
            x = t.inverse(y)
            ld = t.forward_log_det_jacobian(x)
            lp = ld if lp is None else lp + ld
            y = x
        base_lp = self.base.log_prob(y)
        return base_lp - lp if lp is not None else base_lp


# ---------------------------------------------------------------------------
# KL registry (upstream distribution/kl.py)
# ---------------------------------------------------------------------------

_KL_REGISTRY = {}


def register_kl(type_p, type_q):
    """Decorator registering fn(p, q) as KL(p||q) for the class pair."""
    def deco(fn):
        _KL_REGISTRY[(type_p, type_q)] = fn
        return fn
    return deco


def kl_divergence(p: Distribution, q: Distribution):
    """Pair-dispatched KL(p||q); falls back along the MRO like upstream's
    dispatch."""
    matches = [
        (tp, tq) for (tp, tq) in _KL_REGISTRY
        if isinstance(p, tp) and isinstance(q, tq)]
    if not matches:
        raise NotImplementedError(
            f'kl_divergence({type(p).__name__}, {type(q).__name__}) '
            f'is not registered')
    # most-derived match first (smallest combined MRO distance)
    tp, tq = min(matches, key=lambda m: (type(p).__mro__.index(m[0])
                                         + type(q).__mro__.index(m[1])))
    return _KL_REGISTRY[(tp, tq)](p, q)


@register_kl(Normal, Normal)
def _kl_normal(p, q):
    def f(l1, s1, l2, s2):
        return (torch.log(s2 / s1) + (s1 * s1 + (l1 - l2) ** 2)
                / (2 * s2 * s2) - 0.5)
    return apply_op(f, p.loc, p.scale, q.loc, q.scale, _name='kl_normal')


@register_kl(Categorical, Categorical)
def _kl_categorical(p, q):
    def f(a, b):
        pa = torch.log_softmax(a, dim=-1)
        pb = torch.log_softmax(b, dim=-1)
        return torch.sum(torch.exp(pa) * (pa - pb), dim=-1)
    return apply_op(f, p.logits, q.logits, _name='kl_categorical')


@register_kl(Bernoulli, Bernoulli)
def _kl_bernoulli(p, q):
    def f(a, b):
        a = torch.clamp(a, 1e-7, 1 - 1e-7)
        b = torch.clamp(b, 1e-7, 1 - 1e-7)
        return (a * (torch.log(a) - torch.log(b))
                + (1 - a) * (torch.log1p(-a) - torch.log1p(-b)))
    return apply_op(f, p.probs, q.probs, _name='kl_bernoulli')


@register_kl(Beta, Beta)
def _kl_beta(p, q):
    def f(a1, b1, a2, b2):
        return (_logbeta(a2, b2) - _logbeta(a1, b1)
                + (a1 - a2) * digamma(a1)
                + (b1 - b2) * digamma(b1)
                + (a2 - a1 + b2 - b1) * digamma(a1 + b1))
    return apply_op(f, p.alpha, p.beta, q.alpha, q.beta, _name='kl_beta')


@register_kl(Dirichlet, Dirichlet)
def _kl_dirichlet(p, q):
    def f(c1, c2):
        c10 = torch.sum(c1, -1)
        c20 = torch.sum(c2, -1)
        return (gammaln(c10) - gammaln(c20)
                - torch.sum(gammaln(c1) - gammaln(c2), -1)
                + torch.sum((c1 - c2) * (digamma(c1)
                                         - digamma(c10)[..., None]), -1))
    return apply_op(f, p.concentration, q.concentration,
                    _name='kl_dirichlet')


@register_kl(Gamma, Gamma)
def _kl_gamma(p, q):
    def f(a1, b1, a2, b2):
        return ((a1 - a2) * digamma(a1) - gammaln(a1)
                + gammaln(a2) + a2 * (torch.log(b1) - torch.log(b2))
                + a1 * (b2 / b1 - 1.0))
    return apply_op(f, p.concentration, p.rate, q.concentration, q.rate,
                    _name='kl_gamma')


@register_kl(Exponential, Exponential)
def _kl_exponential(p, q):
    return apply_op(
        lambda r1, r2: torch.log(r1) - torch.log(r2) + r2 / r1 - 1.0,
        p.rate, q.rate, _name='kl_exponential')


@register_kl(Geometric, Geometric)
def _kl_geometric(p, q):
    def f(p1, p2):
        return ((1 - p1) / p1 * (torch.log1p(-p1) - torch.log1p(-p2))
                + torch.log(p1) - torch.log(p2))
    return apply_op(f, p.probs, q.probs, _name='kl_geometric')


@register_kl(Laplace, Laplace)
def _kl_laplace(p, q):
    def f(l1, s1, l2, s2):
        d = torch.abs(l1 - l2)
        return (torch.log(s2 / s1) + d / s2
                + s1 / s2 * torch.exp(-d / s1) - 1.0)
    return apply_op(f, p.loc, p.scale, q.loc, q.scale, _name='kl_laplace')


@register_kl(LogNormal, LogNormal)
def _kl_lognormal(p, q):
    # KL is invariant under the shared exp() pushforward
    return _kl_normal(Normal(p.loc, p.scale), Normal(q.loc, q.scale))


@register_kl(Poisson, Poisson)
def _kl_poisson(p, q):
    return apply_op(
        lambda r1, r2: r1 * (torch.log(r1) - torch.log(r2)) + r2 - r1,
        p.rate, q.rate, _name='kl_poisson')


@register_kl(Uniform, Uniform)
def _kl_uniform(p, q):
    def f(lo1, hi1, lo2, hi2):
        inside = (lo2 <= lo1) & (hi1 <= hi2)
        return torch.where(inside, torch.log((hi2 - lo2) / (hi1 - lo1)),
                           math.inf)
    return apply_op(f, p.low, p.high, q.low, q.high, _name='kl_uniform')


@register_kl(Gumbel, Gumbel)
def _kl_gumbel(p, q):
    def f(l1, s1, l2, s2):
        # KL = E_p[z2 + exp(-z2)] + log s2 - H(p) with z2 = (x - l2)/s2:
        # E_p[z2] = (l1 - l2)/s2 + γ s1/s2,
        # E_p[exp(-z2)] = exp((l2 - l1)/s2) Γ(1 + s1/s2)
        ez = (l1 - l2) / s2 + _EULER * s1 / s2
        ee = torch.exp((l2 - l1) / s2) * torch.exp(gammaln(1 + s1 / s2))
        entropy_p = torch.log(s1) + 1.0 + _EULER
        return ez + ee + torch.log(s2) - entropy_p
    return apply_op(f, p.loc, p.scale, q.loc, q.scale, _name='kl_gumbel')


@register_kl(Independent, Independent)
def _kl_independent(p, q):
    if p.reinterpreted_batch_ndims != q.reinterpreted_batch_ndims:
        raise NotImplementedError(
            'kl_divergence between Independents with different '
            'reinterpreted_batch_ndims')
    return p._sum_event(kl_divergence(p.base, q.base))


# the remaining upstream families live in families2.py; imported last so
# its `from . import Distribution, ...` sees the bases defined above
from .families2 import (Binomial, Cauchy, Chi2,  # noqa: E402
                        ContinuousBernoulli, LKJCholesky,
                        MultivariateNormal)

__all__ += ['Binomial', 'Cauchy', 'Chi2', 'ContinuousBernoulli',
            'LKJCholesky', 'MultivariateNormal']
