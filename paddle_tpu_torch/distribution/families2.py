"""Remaining upstream distribution families (counterpart of
`paddle_tpu/distribution/families2.py`; upstream:
python/paddle/distribution/{binomial,cauchy,chi2,continuous_bernoulli,
multivariate_normal,lkj_cholesky}.py).

The same contract as the rest of the zoo: densities and statistics are
torch functions recorded on the tape through `tensor.apply_op`; sampling
draws from a `torch.Generator` (`_gen`); rsample is provided where
upstream has a reparameterized path."""
from __future__ import annotations

import math

import torch
from torch.special import gammaln, xlog1py, xlogy

from ..tensor import apply_op, to_torch

# imported at the END of distribution/__init__, after the base classes
# exist on the package module, so this direct import is not circular
from . import (Distribution, Gamma, _as_t, _beta, _bshape, _gen, _normal,
               _uniform, register_kl)


class Binomial(Distribution):
    """Binomial(total_count n, probs p) (upstream
    distribution/binomial.py)."""

    def __init__(self, total_count, probs, name=None):
        self.total_count = _as_t(total_count)
        self.probs = _as_t(probs)

    @property
    def mean(self):
        return apply_op(lambda n, p: n * p, self.total_count,
                        self.probs, _name='binomial_mean')

    @property
    def variance(self):
        return apply_op(lambda n, p: n * p * (1 - p), self.total_count,
                        self.probs, _name='binomial_var')

    def sample(self, shape=(), seed=0):
        shape = tuple(shape)

        def f(n, p):
            full = shape + _bshape(n, p)
            return torch.binomial(n.expand(full).contiguous(),
                                  p.expand(full).contiguous(),
                                  generator=_gen(seed, p.device))
        return apply_op(f, self.total_count, self.probs,
                        _name='binomial_sample')

    def log_prob(self, value):
        def f(v, n, p):
            comb = (gammaln(n + 1) - gammaln(v + 1)
                    - gammaln(n - v + 1))
            return comb + xlogy(v, p) + xlog1py(n - v, -p)
        return apply_op(f, _as_t(value), self.total_count, self.probs,
                        _name='binomial_log_prob')

    def entropy(self):
        """Exact entropy by support summation (the largest total_count is
        read on the host)."""
        nmax = int(torch.max(to_torch(self.total_count)))

        def f(n, p):
            ks = torch.arange(nmax + 1, dtype=torch.float32,
                              device=p.device)
            kshape = ks.reshape((-1,) + (1,) * max(n.dim(), p.dim()))
            lp = (gammaln(n + 1) - gammaln(kshape + 1)
                  - gammaln(n - kshape + 1)
                  + xlogy(kshape, p) + xlog1py(n - kshape, -p))
            lp = torch.where(kshape <= n, lp, -math.inf)
            return -torch.sum(torch.where(torch.isfinite(lp),
                                          torch.exp(lp) * lp, 0.0), dim=0)
        return apply_op(f, self.total_count, self.probs,
                        _name='binomial_entropy')


class Cauchy(Distribution):
    """Cauchy(loc, scale) (upstream distribution/cauchy.py). Mean and
    variance are undefined and raise, as upstream does."""

    def __init__(self, loc, scale, name=None):
        self.loc = _as_t(loc)
        self.scale = _as_t(scale)

    @property
    def mean(self):
        raise ValueError('Cauchy distribution has no mean')

    @property
    def variance(self):
        raise ValueError('Cauchy distribution has no variance')

    def rsample(self, shape=(), seed=0):
        shape = tuple(shape)

        def f(m, g):
            # tan(pi (u - 1/2)) with u in [eps, 1), jax.random.cauchy's form
            u = _uniform(shape + _bshape(m, g), _gen(seed, m.device),
                         m.device, minval=torch.finfo(torch.float32).eps)
            return m + g * torch.tan(math.pi * (u - 0.5))
        return apply_op(f, self.loc, self.scale, _name='cauchy_sample')

    sample = rsample

    def log_prob(self, value):
        def f(v, m, g):
            z = (v - m) / g
            return -math.log(math.pi) - torch.log(g) - torch.log1p(z * z)
        return apply_op(f, _as_t(value), self.loc, self.scale,
                        _name='cauchy_log_prob')

    def entropy(self):
        return apply_op(lambda g: torch.log(4 * math.pi * g),
                        self.scale, _name='cauchy_entropy')

    def cdf(self, value):
        def f(v, m, g):
            return torch.atan((v - m) / g) / math.pi + 0.5
        return apply_op(f, _as_t(value), self.loc, self.scale,
                        _name='cauchy_cdf')


class Chi2(Gamma):
    """Chi-squared(df) = Gamma(df/2, rate=1/2) (upstream
    distribution/chi2.py). Inherits Gamma's sampling/density, and the
    registered Gamma-Gamma KL via MRO dispatch."""

    def __init__(self, df, name=None):
        df = _as_t(df)
        # the rate on df's device
        super().__init__(concentration=df * 0.5,
                         rate=torch.tensor(0.5, device=df.value.device))
        self.df = df


class ContinuousBernoulli(Distribution):
    """CB(λ) on [0,1] (upstream distribution/continuous_bernoulli.py;
    Loaiza-Ganem & Cunningham 2019). `lims` brackets the unstable
    region around λ=0.5 where the closed forms 0/0: inside it a Taylor
    expansion is used, as upstream does."""

    def __init__(self, probs, lims=(0.499, 0.501), name=None):
        self.probs = _as_t(probs)
        self._lims = lims

    def _unstable(self, lam):
        lo, hi = self._lims
        return (lam > lo) & (lam < hi)

    def _safe(self, lam):
        return torch.where(self._unstable(lam), 0.25, lam)

    def _log_norm(self, lam):
        """log C(λ), C = 2 atanh(1-2λ)/(1-2λ) for λ≠1/2, 2 at 1/2."""
        x = 1.0 - 2.0 * self._safe(lam)
        exact = torch.log(2.0 * torch.atanh(x) / x)
        t = 1.0 - 2.0 * lam  # small inside lims
        taylor = math.log(2.0) + (t * t) / 3.0 + (t ** 4) * 2.0 / 15.0
        return torch.where(self._unstable(lam), taylor, exact)

    def _mean(self, lam):
        safe = self._safe(lam)
        exact = safe / (2.0 * safe - 1.0) \
            + 1.0 / (2.0 * torch.atanh(1.0 - 2.0 * safe))
        taylor = 0.5 + (lam - 0.5) / 3.0  # series about λ=1/2
        return torch.where(self._unstable(lam), taylor, exact)

    @property
    def mean(self):
        return apply_op(self._mean, self.probs, _name='cb_mean')

    @property
    def variance(self):
        def f(lam):
            safe = self._safe(lam)
            x = 1.0 - 2.0 * safe
            at = torch.atanh(x)
            exact = safe * (safe - 1.0) / (x * x) + 1.0 / (4.0 * at * at)
            t = lam - 0.5
            taylor = 1.0 / 12.0 - (t * t) / 15.0
            return torch.where(self._unstable(lam), taylor, exact)
        return apply_op(f, self.probs, _name='cb_var')

    def _icdf(self, u, lam):
        safe = self._safe(lam)
        num = torch.log1p(u * (2.0 * safe - 1.0) / (1.0 - safe))
        den = torch.log(safe) - torch.log1p(-safe)
        return torch.where(self._unstable(lam), u, num / den)

    def icdf(self, value):
        return apply_op(self._icdf, _as_t(value), self.probs,
                        _name='cb_icdf')

    def rsample(self, shape=(), seed=0):
        shape = tuple(shape)

        def f(lam):
            u = _uniform(shape + lam.shape, _gen(seed, lam.device),
                         lam.device)
            return self._icdf(u, lam)
        return apply_op(f, self.probs, _name='cb_sample')

    sample = rsample

    def log_prob(self, value):
        def f(v, lam):
            return (xlogy(v, lam) + xlog1py(1.0 - v, -lam)
                    + self._log_norm(lam))
        return apply_op(f, _as_t(value), self.probs,
                        _name='cb_log_prob')

    def entropy(self):
        def f(lam):
            mu = self._mean(lam)
            return -(self._log_norm(lam) + xlogy(mu, lam)
                     + xlog1py(1.0 - mu, -lam))
        return apply_op(f, self.probs, _name='cb_entropy')


def _diag(l):
    return torch.diagonal(l, dim1=-2, dim2=-1)


class MultivariateNormal(Distribution):
    """MVN(loc, covariance_matrix | precision_matrix | scale_tril)
    (upstream distribution/multivariate_normal.py). Internally
    parameterized by the Cholesky factor L: every density and sampling
    op is a triangular solve or a matmul."""

    def __init__(self, loc, covariance_matrix=None,
                 precision_matrix=None, scale_tril=None, name=None):
        self.loc = _as_t(loc)
        given = [a is not None for a in
                 (covariance_matrix, precision_matrix, scale_tril)]
        if sum(given) != 1:
            raise ValueError('pass exactly one of covariance_matrix, '
                             'precision_matrix, scale_tril')
        if scale_tril is not None:
            self.scale_tril = _as_t(scale_tril)
        elif covariance_matrix is not None:
            self.scale_tril = apply_op(torch.linalg.cholesky,
                                       _as_t(covariance_matrix),
                                       _name='mvn_chol')
        else:
            def inv_chol(prec):
                # prec = Lp Lpᵀ  ⇒  cov = Lp⁻ᵀ Lp⁻¹ (batched)
                lp = torch.linalg.cholesky(prec)
                eye = torch.eye(prec.shape[-1], dtype=prec.dtype,
                                device=prec.device).expand(prec.shape)
                linv = torch.linalg.solve_triangular(lp, eye, upper=False)
                cov = linv.transpose(-1, -2) @ linv
                return torch.linalg.cholesky(cov)
            self.scale_tril = apply_op(inv_chol, _as_t(precision_matrix),
                                       _name='mvn_prec_chol')

    @property
    def mean(self):
        return self.loc

    @property
    def covariance_matrix(self):
        return apply_op(lambda l: l @ l.transpose(-1, -2),
                        self.scale_tril, _name='mvn_cov')

    @property
    def variance(self):
        return apply_op(lambda l: torch.sum(l * l, dim=-1), self.scale_tril,
                        _name='mvn_var')

    def rsample(self, shape=(), seed=0):
        shape = tuple(shape)

        def f(mu, l):
            d = l.shape[-1]
            base = torch.broadcast_shapes(mu.shape[:-1], l.shape[:-2])
            eps = _normal(shape + base + (d,), _gen(seed, mu.device),
                          mu.device)
            return mu + torch.einsum('...ij,...j->...i', l, eps)
        return apply_op(f, self.loc, self.scale_tril,
                        _name='mvn_sample')

    sample = rsample

    def log_prob(self, value):
        def f(v, mu, l):
            d = l.shape[-1]
            diff = v - mu
            bshape = torch.broadcast_shapes(diff.shape[:-1], l.shape[:-2])
            diff = diff.expand(bshape + diff.shape[-1:])
            lb = l.expand(bshape + l.shape[-2:])
            z = torch.linalg.solve_triangular(
                lb, diff[..., None], upper=False)[..., 0]
            half_logdet = torch.sum(torch.log(_diag(l)), dim=-1)
            return (-0.5 * torch.sum(z * z, dim=-1) - half_logdet
                    - 0.5 * d * math.log(2 * math.pi))
        return apply_op(f, _as_t(value), self.loc, self.scale_tril,
                        _name='mvn_log_prob')

    def entropy(self):
        def f(l):
            d = l.shape[-1]
            half_logdet = torch.sum(torch.log(_diag(l)), dim=-1)
            return 0.5 * d * (1.0 + math.log(2 * math.pi)) + half_logdet
        return apply_op(f, self.scale_tril, _name='mvn_entropy')


class LKJCholesky(Distribution):
    """LKJ prior over Cholesky factors of correlation matrices
    (upstream distribution/lkj_cholesky.py). Sampling uses the onion
    construction (d-1 Beta draws plus points on spheres), as one batched
    computation, or the C-vine."""

    def __init__(self, dim, concentration=1.0,
                 sample_method='onion', name=None):
        if dim < 2:
            raise ValueError('LKJCholesky needs dim >= 2')
        if sample_method not in ('onion', 'cvine'):
            raise ValueError(f'unknown sample_method {sample_method!r}')
        self.dim = int(dim)
        self.concentration = _as_t(concentration)
        self.sample_method = sample_method

    def sample(self, shape=(), seed=0):
        shape = tuple(shape)
        f = self._sample_onion if self.sample_method == 'onion' \
            else self._sample_cvine
        return apply_op(
            lambda conc: f(conc, _gen(seed, conc.device), shape),
            self.concentration, _name='lkj_sample')

    def _assemble(self, w, diag_rest, batch, device):
        """The factor from its strictly-lower rows 1..d-1 (`w`) and its
        diagonal below the first entry."""
        d = self.dim
        low = torch.cat([torch.zeros(batch + (1, d), device=device), w],
                        dim=-2)
        diag = torch.cat([torch.ones(batch + (1,), device=device),
                          diag_rest], dim=-1)
        eye = torch.eye(d, device=device)
        return low * (1.0 - eye) + diag[..., None] * eye

    def _sample_onion(self, conc, g, shape):
        d = self.dim
        dev = conc.device
        batch = shape + tuple(conc.shape)
        # onion: row i (1-based, i>=1) needs y~Beta(i/2, off_i)
        # with offset walking down from conc + (d-2)/2
        i = torch.arange(1, d, dtype=torch.float32, device=dev)
        offs = conc[..., None] + (d - 2) / 2.0 - (i - 1) / 2.0
        y = _beta(i / 2.0, offs, batch + (d - 1,), g)
        z = _normal(batch + (d - 1, d), g, dev)
        # unit vectors on the first i coords of each row
        rowmask = torch.arange(d, device=dev)[None, :] < i[:, None]
        z = torch.where(rowmask, z, 0.0)
        u = z / torch.clamp(torch.linalg.norm(z, dim=-1, keepdim=True),
                            min=1e-20)
        w = torch.sqrt(y)[..., None] * u
        return self._assemble(w, torch.sqrt(1.0 - y), batch, dev)

    def _sample_cvine(self, conc, g, shape):
        """C-vine (Lewandowski et al. 2009 §3.1): partial correlations
        z_ij ~ 2·Beta(a_j, a_j) − 1 with a_j = conc + (d−2−j)/2 by tree
        level j, mapped to the Cholesky factor by the recursive
        sqrt(1−z²) cumulative product, here one batched cumprod."""
        d = self.dim
        dev = conc.device
        batch = shape + tuple(conc.shape)
        j = torch.arange(d, dtype=torch.float32, device=dev)
        a = conc[..., None, None] + (d - 2.0 - j) / 2.0
        y = _beta(a, a, batch + (d - 1, d), g)
        z = 2.0 * y - 1.0  # partial correlations in (-1, 1)
        rows = torch.arange(1, d, device=dev)[:, None]
        cols = torch.arange(d, device=dev)[None, :]
        mask = cols < rows  # row i uses levels j = 0..i-1
        z = torch.where(mask, z, 0.0)
        # cum_ij = prod_{k<j} sqrt(1 - z_ik^2)  (exclusive cumprod)
        s = torch.sqrt(torch.clamp(1.0 - z * z, min=1e-20))
        cum = torch.cumprod(torch.where(mask, s, 1.0), dim=-1)
        excl = torch.cat([torch.ones(batch + (d - 1, 1), device=dev),
                          cum[..., :-1]], dim=-1)
        w = torch.where(mask, z * excl, 0.0)
        # L_ii = prod_{k<i} sqrt(1 - z_ik^2) = cum at the last used level
        diag_low = torch.gather(
            cum, -1, (rows - 1).expand(batch + (d - 1, 1)))[..., 0]
        return self._assemble(w, diag_low, batch, dev)

    def log_prob(self, value):
        d = self.dim

        def f(l, conc):
            i = torch.arange(1, d, dtype=torch.float32, device=l.device)
            order = 2.0 * (conc[..., None] - 1.0) + d - i - 1.0
            diags = _diag(l)[..., 1:]
            unnorm = torch.sum(order * torch.log(diags), dim=-1)
            # normalization constant (LKJ 2009 p.1999, Cholesky-factor
            # density): ½(d−1)·log π + log Γ_{d−1}(α − ½) − (d−1)·log Γ(α)
            # with α = conc + (d−1)/2 and Γ_p the multivariate gamma
            dm1 = d - 1
            alpha = conc + 0.5 * dm1
            j = torch.arange(1, dm1 + 1, dtype=torch.float32,
                             device=l.device)
            mvlg = dm1 * (dm1 - 1) / 4.0 * math.log(math.pi) + torch.sum(
                gammaln(alpha[..., None] - 0.5 + (1.0 - j) / 2.0), dim=-1)
            norm = (0.5 * dm1 * math.log(math.pi) + mvlg
                    - dm1 * gammaln(alpha))
            return unnorm - norm
        return apply_op(f, _as_t(value), self.concentration,
                        _name='lkj_log_prob')


# closed-form KLs for the new pairs
@register_kl(Cauchy, Cauchy)
def _kl_cauchy(p, q):
    def f(m0, g0, m1, g1):
        return torch.log(((g0 + g1) ** 2 + (m0 - m1) ** 2)
                         / (4.0 * g0 * g1))
    return apply_op(f, p.loc, p.scale, q.loc, q.scale,
                    _name='kl_cauchy')


@register_kl(MultivariateNormal, MultivariateNormal)
def _kl_mvn(p, q):
    def f(mu0, l0, mu1, l1):
        d = l0.shape[-1]
        bshape = torch.broadcast_shapes(l0.shape[:-2], l1.shape[:-2],
                                        mu0.shape[:-1], mu1.shape[:-1])
        l0 = l0.expand(bshape + l0.shape[-2:])
        l1 = l1.expand(bshape + l1.shape[-2:])
        diff = (mu1 - mu0).expand(bshape + (d,))
        half0 = torch.sum(torch.log(_diag(l0)), dim=-1)
        half1 = torch.sum(torch.log(_diag(l1)), dim=-1)
        m = torch.linalg.solve_triangular(l1, l0, upper=False)
        tr = torch.sum(m * m, dim=(-2, -1))
        z = torch.linalg.solve_triangular(
            l1, diff[..., None], upper=False)[..., 0]
        return half1 - half0 + 0.5 * (tr + torch.sum(z * z, dim=-1) - d)
    return apply_op(f, p.loc, p.scale_tril, q.loc, q.scale_tril,
                    _name='kl_mvn')
