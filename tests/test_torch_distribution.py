"""`distribution` of the port against the JAX package's, on the CPU.

The same seeded parameters and values go through both packages: every
family's log_prob, entropy, mean and variance, every registered KL pair
and every transform's forward, inverse and log-det-Jacobians agree
within rtol 1e-5 (atol 1e-5 of the output's scale: lgamma and digamma
are two implementations). The packages draw from different streams
(the port from `torch.Generator`s), so sampling is held by statistics:
20,000 draws whose mean and variance lie within 5 standard errors of
the family's own; one seed gives the same draws twice. Gamma, Beta and
Dirichlet `rsample` gradients are the port's d sample / d concentration
at its own draws, held to `jax.lax.random_gamma_grad` at those draws
within rtol 1e-3 (GRAD_TOL): torch's `_standard_gamma_grad` is an
approximation whose relative error against the float64 derivative
reaches 6.8e-4 over 200,000 draws at concentrations in [0.3, 4] (the
JAX float32 one's 4.9e-5).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu import distribution as JD
from paddle_tpu_torch import distribution as TD

TOL = 1e-5
GRAD_TOL = 1e-3
N_DRAWS = 20000


@pytest.fixture(autouse=True, scope='module')
def _cpu_place():
    ptt.set_device('cpu')
    yield
    ptt.set_device('gpu')


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x.numpy()) if hasattr(x, 'numpy') else np.asarray(x)


def _close(got, want, tol=TOL):
    got, want = np.asarray(_np(got), np.float64), np.asarray(_np(want),
                                                             np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_array_equal(got[~finite], want[~finite])
    scale = max(float(np.abs(want[finite]).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got[finite], want[finite], rtol=tol,
                               atol=tol * scale)


def _jt(a):
    return paddle.to_tensor(np.array(a, np.float32))


def _tt(a):
    return ptt.to_tensor(np.array(a, np.float32))


ALPHA = np.array([0.7, 1.5, 3.0], np.float32)
BETA = np.array([1.2, 0.8, 2.5], np.float32)
LOC = np.array([-0.5, 0.0, 1.5], np.float32)
SCALE = np.array([0.4, 1.0, 2.2], np.float32)
RATE = np.array([0.5, 1.3, 4.0], np.float32)
PROB = np.array([0.2, 0.5, 0.8], np.float32)
DF = np.array([3.0, 5.0, 10.0], np.float32)
LOGITS = np.array([[0.1, 0.5, -1.0], [2.0, 0.0, 0.3]], np.float32)
COV = np.array([[2.0, 0.3, 0.1], [0.3, 1.0, 0.2], [0.1, 0.2, 0.5]],
               np.float32)
CORR = np.linalg.cholesky(np.array([[1.0, 0.3, 0.1], [0.3, 1.0, 0.2],
                                    [0.1, 0.2, 1.0]])).astype(np.float32)

# (name, build(D, t), values drawn with a numpy Generator)
FAMILIES = [
    ('normal', lambda D, t: D.Normal(t(LOC), t(SCALE)),
     lambda r: r.standard_normal((4, 3)) * 2),
    ('uniform', lambda D, t: D.Uniform(t(LOC), t(LOC + SCALE)),
     lambda r: r.uniform(-1.0, 4.0, (4, 3))),
    ('categorical', lambda D, t: D.Categorical(t(LOGITS)),
     lambda r: r.integers(0, 3, (2,))),
    # not p = 0.5 (the sampling test): there a Bernoulli's sample variance
    # is a function of its sample mean at its stationary point
    ('bernoulli', lambda D, t: D.Bernoulli(t([0.2, 0.35, 0.8])),
     lambda r: r.integers(0, 2, (4, 3))),
    ('beta', lambda D, t: D.Beta(t(ALPHA), t(BETA)),
     lambda r: r.uniform(0.05, 0.95, (4, 3))),
    ('dirichlet', lambda D, t: D.Dirichlet(t(ALPHA)),
     lambda r: r.dirichlet(ALPHA, 4)),
    ('gamma', lambda D, t: D.Gamma(t(ALPHA), t(RATE)),
     lambda r: r.uniform(0.1, 5.0, (4, 3))),
    ('exponential', lambda D, t: D.Exponential(t(RATE)),
     lambda r: r.uniform(0.05, 4.0, (4, 3))),
    ('geometric', lambda D, t: D.Geometric(t(PROB)),
     lambda r: r.integers(0, 8, (4, 3))),
    ('gumbel', lambda D, t: D.Gumbel(t(LOC), t(SCALE)),
     lambda r: r.standard_normal((4, 3)) * 2),
    ('laplace', lambda D, t: D.Laplace(t(LOC), t(SCALE)),
     lambda r: r.standard_normal((4, 3)) * 2),
    ('lognormal', lambda D, t: D.LogNormal(t(LOC), t(SCALE)),
     lambda r: r.uniform(0.1, 6.0, (4, 3))),
    ('multinomial', lambda D, t: D.Multinomial(6, t([0.2, 0.3, 0.5])),
     lambda r: r.multinomial(6, [0.2, 0.3, 0.5], 4)),
    ('poisson', lambda D, t: D.Poisson(t(RATE)),
     lambda r: r.integers(0, 10, (4, 3))),
    ('studentt', lambda D, t: D.StudentT(t(DF), t(LOC), t(SCALE)),
     lambda r: r.standard_normal((4, 3)) * 2),
    ('binomial', lambda D, t: D.Binomial(t([5.0, 10.0, 20.0]), t(PROB)),
     lambda r: r.integers(0, 6, (4, 3))),
    ('cauchy', lambda D, t: D.Cauchy(t(LOC), t(SCALE)),
     lambda r: r.standard_normal((4, 3)) * 2),
    ('chi2', lambda D, t: D.Chi2(t(DF)),
     lambda r: r.uniform(0.1, 8.0, (4, 3))),
    ('continuous_bernoulli',
     lambda D, t: D.ContinuousBernoulli(t([0.2, 0.4995, 0.8])),
     lambda r: r.uniform(0.01, 0.99, (4, 3))),
    ('mvn', lambda D, t: D.MultivariateNormal(t(LOC),
                                              covariance_matrix=t(COV)),
     lambda r: r.standard_normal((4, 3))),
    ('lkj_cholesky', lambda D, t: D.LKJCholesky(3, t(1.5)),
     lambda r: CORR),
]
IDS = [f[0] for f in FAMILIES]
NO_ENTROPY = {'multinomial', 'lkj_cholesky'}
NO_MOMENTS = {'categorical', 'cauchy', 'lkj_cholesky'}


def _pair(build):
    return build(TD, _tt), build(JD, _jt)


@pytest.mark.parametrize('case', FAMILIES, ids=IDS)
def test_family_statistics_match_jax(case):
    name, build, values = case
    td, jd = _pair(build)
    v = np.asarray(values(np.random.default_rng(len(name))), np.float32)
    _close(td.log_prob(_tt(v)), jd.log_prob(_jt(v)))
    _close(td.prob(_tt(v)), jd.prob(_jt(v)))
    if name not in NO_ENTROPY:
        _close(td.entropy(), jd.entropy())
    if name not in NO_MOMENTS:
        _close(td.mean, jd.mean)
        _close(td.variance, jd.variance)
    # a draw has the shape of one value (batch + event shape), as in JAX
    one = v.shape if name in ('categorical', 'lkj_cholesky') else v.shape[1:]
    assert tuple(td.sample((5,)).shape) == (5,) + tuple(one)


def test_parameters_become_float32_on_the_current_place():
    n = TD.Normal(0, 1)
    assert n.loc.dtype == torch.float32 and n.scale.dtype == torch.float32
    assert n.loc.place == ptt.CPUPlace()
    g = TD.Gamma(np.array([1, 2]), 3.0)
    assert g.concentration.dtype == torch.float32
    kept = _tt([1.0]).astype('float64')
    assert TD.Normal(kept, 1.0).loc is kept


KL_PAIRS = [
    ('normal', lambda D, t: (D.Normal(t(LOC), t(SCALE)),
                             D.Normal(t(LOC[::-1]), t(RATE)))),
    ('categorical', lambda D, t: (D.Categorical(t(LOGITS)),
                                  D.Categorical(t(LOGITS[:, ::-1])))),
    ('bernoulli', lambda D, t: (D.Bernoulli(t(PROB)),
                                D.Bernoulli(t(PROB[::-1])))),
    ('beta', lambda D, t: (D.Beta(t(ALPHA), t(BETA)),
                           D.Beta(t(BETA), t(ALPHA)))),
    ('dirichlet', lambda D, t: (D.Dirichlet(t(ALPHA)),
                                D.Dirichlet(t(BETA)))),
    ('gamma', lambda D, t: (D.Gamma(t(ALPHA), t(RATE)),
                            D.Gamma(t(BETA), t(SCALE)))),
    ('exponential', lambda D, t: (D.Exponential(t(RATE)),
                                  D.Exponential(t(SCALE)))),
    ('geometric', lambda D, t: (D.Geometric(t(PROB)),
                                D.Geometric(t(PROB[::-1])))),
    ('laplace', lambda D, t: (D.Laplace(t(LOC), t(SCALE)),
                              D.Laplace(t(LOC[::-1]), t(RATE)))),
    ('lognormal', lambda D, t: (D.LogNormal(t(LOC), t(SCALE)),
                                D.LogNormal(t(LOC[::-1]), t(RATE)))),
    ('poisson', lambda D, t: (D.Poisson(t(RATE)), D.Poisson(t(SCALE)))),
    ('uniform', lambda D, t: (D.Uniform(t(LOC), t(LOC + SCALE)),
                              D.Uniform(t(LOC - 1.0), t(LOC + 3.0)))),
    ('uniform_outside', lambda D, t: (D.Uniform(t(LOC), t(LOC + SCALE)),
                                      D.Uniform(t(LOC + 0.1),
                                                t(LOC + 3.0)))),
    ('gumbel', lambda D, t: (D.Gumbel(t(LOC), t(SCALE)),
                             D.Gumbel(t(LOC[::-1]), t(RATE)))),
    ('independent', lambda D, t: (
        D.Independent(D.Normal(t(LOC), t(SCALE)), 1),
        D.Independent(D.Normal(t(LOC[::-1]), t(RATE)), 1))),
    ('cauchy', lambda D, t: (D.Cauchy(t(LOC), t(SCALE)),
                             D.Cauchy(t(LOC[::-1]), t(RATE)))),
    ('mvn', lambda D, t: (
        D.MultivariateNormal(t(LOC), covariance_matrix=t(COV)),
        D.MultivariateNormal(t(LOC[::-1]), scale_tril=t(CORR)))),
    ('chi2_through_gamma', lambda D, t: (D.Chi2(t(DF)),
                                         D.Gamma(t(ALPHA), t(RATE)))),
]


@pytest.mark.parametrize('case', KL_PAIRS, ids=[k[0] for k in KL_PAIRS])
def test_kl_pairs_match_jax(case):
    _, build = case
    tp, tq = build(TD, _tt)
    jp, jq = build(JD, _jt)
    _close(TD.kl_divergence(tp, tq), JD.kl_divergence(jp, jq))


def test_kl_registry_dispatch_and_errors():
    with pytest.raises(NotImplementedError, match='not registered'):
        TD.kl_divergence(TD.Normal(0.0, 1.0), TD.Gamma(1.0, 1.0))

    class MyNormal(TD.Normal):
        pass

    @TD.register_kl(MyNormal, MyNormal)
    def _kl(p, q):
        return ptt.to_tensor(42.0)
    assert float(TD.kl_divergence(MyNormal(0.0, 1.0),
                                  MyNormal(1.0, 1.0))) == 42.0
    _close(TD.kl_divergence(MyNormal(0.0, 1.0), TD.Normal(1.0, 2.0)),
           JD.kl_divergence(JD.Normal(0.0, 1.0), JD.Normal(1.0, 2.0)))
    with pytest.raises(NotImplementedError, match='reinterpreted'):
        TD.kl_divergence(TD.Independent(TD.Normal(_tt(LOC), 1.0), 1),
                         TD.Independent(TD.Normal(_tt(LOC), 1.0), 0))


TRANSFORMS = [
    ('affine', lambda D, t: D.AffineTransform(t(LOC), t(-SCALE)),
     lambda r: r.standard_normal((2, 3))),
    ('exp', lambda D, t: D.ExpTransform(),
     lambda r: r.standard_normal((2, 3))),
    ('sigmoid', lambda D, t: D.SigmoidTransform(),
     lambda r: r.standard_normal((2, 3)) * 3),
    ('tanh', lambda D, t: D.TanhTransform(),
     lambda r: r.standard_normal((2, 3))),
    ('power', lambda D, t: D.PowerTransform(t(2.5)),
     lambda r: r.uniform(0.2, 3.0, (2, 3))),
    ('abs', lambda D, t: D.AbsTransform(),
     lambda r: r.uniform(0.2, 3.0, (2, 3))),
    ('chain', lambda D, t: D.ChainTransform([
        D.AffineTransform(t(0.5), t(2.0)), D.TanhTransform(),
        D.AffineTransform(t(1.5), t(0.5)), D.PowerTransform(t(1.7))]),
     lambda r: r.standard_normal((2, 3)) * 0.5),
]


@pytest.mark.parametrize('case', TRANSFORMS, ids=[c[0] for c in TRANSFORMS])
def test_transforms_match_jax(case):
    name, build, values = case
    tt, jt = build(TD, _tt), build(JD, _jt)
    x = np.asarray(values(np.random.default_rng(len(name))), np.float32)
    ty, jy = tt.forward(_tt(x)), jt.forward(_jt(x))
    _close(ty, jy)
    _close(tt(_tt(x)), jy)
    y = np.asarray(_np(jy), np.float32)
    _close(tt.inverse(_tt(y)), jt.inverse(_jt(y)))
    _close(tt.forward_log_det_jacobian(_tt(x)),
           jt.forward_log_det_jacobian(_jt(x)))
    _close(tt.inverse_log_det_jacobian(_tt(y)),
           jt.inverse_log_det_jacobian(_jt(y)))


def test_wrappers_match_jax():
    v = np.random.default_rng(2).uniform(0.2, 4.0, (5, 3)).astype(np.float32)
    for D, t, out in ((TD, _tt, []), (JD, _jt, [])):
        ind = D.Independent(D.Gamma(t(ALPHA), t(RATE)), 1)
        out += [ind.log_prob(t(v)), ind.entropy(), ind.mean, ind.variance]
        td = D.TransformedDistribution(
            D.Normal(t(LOC), t(SCALE)),
            [D.ExpTransform(), D.AffineTransform(t(0.5), t(2.0))])
        out += [td.log_prob(t(v + 0.6))]
        out += [D.Categorical(t(LOGITS)).probs(),
                D.Categorical(t(LOGITS)).probs(t([2, 0])),
                D.Cauchy(t(LOC), t(SCALE)).cdf(t(v[:, :3])),
                D.ContinuousBernoulli(t([0.2, 0.4995, 0.8])).icdf(
                    t(v / 5.0))]
        prec = np.linalg.inv(COV).astype(np.float32)
        out += [D.MultivariateNormal(t(LOC), precision_matrix=t(
            prec)).scale_tril,
            D.MultivariateNormal(t(LOC), covariance_matrix=t(
                COV)).covariance_matrix]
        out += [D.LKJCholesky(3, t(1.5), 'cvine').log_prob(t(CORR))]
        if D is TD:
            torch_out = out
        else:
            jax_out = out
    for got, want in zip(torch_out, jax_out):
        _close(got, want)
    with pytest.raises(ValueError, match='exactly one'):
        TD.MultivariateNormal(_tt(LOC))
    with pytest.raises(ValueError, match='no mean'):
        TD.Cauchy(0.0, 1.0).mean
    with pytest.raises(ValueError, match='dim >= 2'):
        TD.LKJCholesky(1)


def _moments(samples, axis=0):
    s = np.asarray(_np(samples), np.float64)
    n = s.shape[axis]
    mean = s.mean(axis)
    var = s.var(axis, ddof=1)
    m4 = ((s - mean) ** 4).mean(axis)
    # the standard errors of the sample mean and the sample variance
    return n, mean, var, np.sqrt(var / n), np.sqrt(
        (m4 - var ** 2 * (n - 3) / (n - 1)) / n)


@pytest.mark.parametrize('case', [f for f in FAMILIES
                                  if f[0] not in NO_MOMENTS],
                         ids=[i for i in IDS if i not in NO_MOMENTS])
def test_sampling_statistics_and_seeds(case):
    name, build, _ = case
    td, _ = _pair(build)
    samples = td.sample((N_DRAWS,), seed=11)
    assert samples.dtype == torch.float32
    n, mean, var, se_mean, se_var = _moments(samples)
    want_mean = np.asarray(_np(td.mean), np.float64)
    want_var = np.asarray(_np(td.variance), np.float64)
    if name == 'mvn':       # the variance is the covariance's diagonal
        want_var = np.diag(COV).astype(np.float64)
    assert (np.abs(mean - want_mean) <= 5 * se_mean + 1e-6).all(), \
        (mean, want_mean)
    finite = np.isfinite(want_var)
    assert (np.abs(var - want_var)[finite]
            <= 5 * se_var[finite] + 1e-6).all(), (var, want_var)
    again = td.sample((N_DRAWS,), seed=11)
    assert torch.equal(samples.value, again.value)
    assert not torch.equal(samples.value, td.sample((N_DRAWS,),
                                                    seed=12).value)


def test_seed_zero_draws_from_the_framework_stream():
    d = TD.Normal(_tt(LOC), _tt(SCALE))
    ptt.seed(5)
    a, b = d.sample((4,)), d.sample((4,))
    assert not torch.equal(a.value, b.value)
    ptt.seed(5)
    assert torch.equal(d.sample((4,)).value, a.value)


def test_cauchy_and_lkj_samples():
    c = TD.Cauchy(_tt(LOC), _tt(SCALE)).sample((N_DRAWS,), seed=3)
    med = np.median(_np(c), axis=0)
    # the median's standard error is pi * scale / (2 sqrt(n))
    assert (np.abs(med - LOC) <= 5 * np.pi * SCALE / 2
            / np.sqrt(N_DRAWS)).all()
    for method in ('onion', 'cvine'):
        low = _np(TD.LKJCholesky(3, _tt(2.0), method).sample((2000,),
                                                             seed=4))
        np.testing.assert_allclose(np.linalg.norm(low, axis=-1), 1.0,
                                   atol=1e-5)
        assert np.allclose(np.triu(low, 1), 0.0)
        assert (np.diagonal(low, axis1=-2, axis2=-1) > 0).all()
        corr = low @ np.swapaxes(low, -1, -2)
        # LKJ(eta) marginals of an off-diagonal: Beta(eta - 1 + d/2)
        # on (-1, 1), mean 0, variance 1 / (2 (eta - 1 + d/2) + 1)
        off = corr[:, 1, 0]
        se = np.sqrt(1.0 / (2 * (2.0 - 1 + 1.5) + 1) / off.size)
        assert abs(off.mean()) <= 5 * se


def _gamma_grad(a, x):
    return np.asarray(jax.lax.random_gamma_grad(jnp.asarray(a, jnp.float32),
                                                jnp.asarray(x, jnp.float32)))


def test_gamma_rsample_gradient_is_implicit_reparameterization():
    rng = np.random.default_rng(8)
    a = ptt.to_tensor(rng.uniform(0.3, 4.0, 64).astype(np.float32))
    b = ptt.to_tensor(rng.uniform(0.5, 2.0, 64).astype(np.float32))
    a.stop_gradient = False
    s = TD.Gamma(a, b).rsample(seed=9)
    (g,) = ptt.grad(s.sum(), [a])
    raw = _np(s) * _np(b)                   # the standard gamma draws
    _close(g, _gamma_grad(_np(a), raw) / _np(b), GRAD_TOL)


def test_beta_rsample_gradient_is_implicit_reparameterization():
    rng = np.random.default_rng(9)
    a = ptt.to_tensor(rng.uniform(0.5, 4.0, 64).astype(np.float32))
    b = ptt.to_tensor(rng.uniform(0.5, 4.0, 64).astype(np.float32))
    a.stop_gradient = b.stop_gradient = False
    s = TD.Beta(a, b).rsample(seed=10)
    ga_grad, gb_grad = ptt.grad(s.sum(), [a, b])
    gen = torch.Generator().manual_seed(10)    # the same draws: a's, b's
    ga = _np(TD._gamma(a.value.detach(), (64,), gen))
    gb = _np(TD._gamma(b.value.detach(), (64,), gen))
    np.testing.assert_allclose(_np(s), ga / (ga + gb), rtol=1e-6)
    tot2 = (ga + gb) ** 2
    _close(ga_grad, _gamma_grad(_np(a), ga) * gb / tot2, GRAD_TOL)
    _close(gb_grad, -_gamma_grad(_np(b), gb) * ga / tot2, GRAD_TOL)


def test_dirichlet_rsample_gradient_is_implicit_reparameterization():
    c = ptt.to_tensor(np.array([0.6, 1.5, 3.0, 0.9], np.float32))
    c.stop_gradient = False
    w = np.random.default_rng(10).standard_normal((16, 4)).astype(
        np.float32)
    s = TD.Dirichlet(c).rsample((16,), seed=12)
    (grad,) = ptt.grad((s * ptt.to_tensor(w)).sum(), [c])
    gen = torch.Generator().manual_seed(12)
    g = _np(TD._gamma(c.value.detach(), (16, 4), gen))
    tot = g.sum(-1, keepdims=True)
    x = g / tot
    np.testing.assert_allclose(_np(s), x, rtol=1e-6)
    dg = _gamma_grad(np.broadcast_to(_np(c), g.shape), g)
    want = (dg * (w - (w * x).sum(-1, keepdims=True)) / tot).sum(0)
    _close(grad, want, GRAD_TOL)
