"""Elementwise math, comparison and logical ops (counterpart of
`paddle_tpu/ops/math.py`), each one torch function under the JAX op's
name. A Python scalar beside a tensor takes part as a 0-d tensor on the
tensor's device, which keeps the tensor's dtype within its kind (a float
scalar promotes an integer tensor to the default float, as JAX's weak
types do)."""
from __future__ import annotations

import builtins

import torch

from ..tensor import to_torch
from ._helpers import defop


def _pair(x, y):
    """(x, y) as tensors: a non-tensor beside a tensor becomes a 0-d
    tensor on its device."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, device=y.device if isinstance(
            y, torch.Tensor) else None)
    if not isinstance(y, torch.Tensor):
        y = torch.as_tensor(y, device=x.device)
    return x, y


def _binary(fn, name):
    return defop(lambda x, y: fn(*_pair(x, y)), name=name)


def _unary(fn, name):
    return defop(lambda x: fn(x), name=name)


def _float(v):
    """Integer and bool inputs as the default float (jnp's transcendental
    functions promote them)."""
    return v if v.is_floating_point() or v.is_complex() else v.float()


# -- binary elementwise ----------------------------------------------------

add = _binary(torch.add, 'add')
subtract = _binary(torch.subtract, 'subtract')
multiply = _binary(torch.multiply, 'multiply')
divide = _binary(torch.true_divide, 'divide')
floor_divide = _binary(lambda x, y: torch.div(x, y, rounding_mode='floor'),
                       'floor_divide')
mod = _binary(torch.remainder, 'mod')
remainder = mod
floor_mod = mod
pow = _binary(torch.pow, 'pow')
maximum = _binary(torch.maximum, 'maximum')
minimum = _binary(torch.minimum, 'minimum')
fmax = _binary(torch.fmax, 'fmax')
fmin = _binary(torch.fmin, 'fmin')
atan2 = _binary(lambda x, y: torch.atan2(_float(x), _float(y)), 'atan2')
hypot = _binary(torch.hypot, 'hypot')
copysign = _binary(torch.copysign, 'copysign')
heaviside = _binary(torch.heaviside, 'heaviside')
gcd = _binary(torch.gcd, 'gcd')
lcm = _binary(torch.lcm, 'lcm')
inner = _binary(torch.inner, 'inner')
outer = _binary(lambda x, y: torch.outer(x.reshape(-1), y.reshape(-1)),
                'outer')
logaddexp = _binary(torch.logaddexp, 'logaddexp')

# -- unary elementwise -----------------------------------------------------

exp = _unary(lambda x: torch.exp(_float(x)), 'exp')
expm1 = _unary(lambda x: torch.expm1(_float(x)), 'expm1')
log = _unary(lambda x: torch.log(_float(x)), 'log')
log2 = _unary(lambda x: torch.log2(_float(x)), 'log2')
log10 = _unary(lambda x: torch.log10(_float(x)), 'log10')
log1p = _unary(lambda x: torch.log1p(_float(x)), 'log1p')
sqrt = _unary(lambda x: torch.sqrt(_float(x)), 'sqrt')
rsqrt = _unary(lambda x: torch.rsqrt(_float(x)), 'rsqrt')
abs = _unary(torch.abs, 'abs')
neg = _unary(torch.neg, 'neg')
sign = _unary(torch.sign, 'sign')
sin = _unary(lambda x: torch.sin(_float(x)), 'sin')
cos = _unary(lambda x: torch.cos(_float(x)), 'cos')
tan = _unary(lambda x: torch.tan(_float(x)), 'tan')
asin = _unary(lambda x: torch.asin(_float(x)), 'asin')
acos = _unary(lambda x: torch.acos(_float(x)), 'acos')
atan = _unary(lambda x: torch.atan(_float(x)), 'atan')
sinh = _unary(lambda x: torch.sinh(_float(x)), 'sinh')
cosh = _unary(lambda x: torch.cosh(_float(x)), 'cosh')
tanh = _unary(lambda x: torch.tanh(_float(x)), 'tanh')
asinh = _unary(lambda x: torch.asinh(_float(x)), 'asinh')
acosh = _unary(lambda x: torch.acosh(_float(x)), 'acosh')
atanh = _unary(lambda x: torch.atanh(_float(x)), 'atanh')
erf = _unary(lambda x: torch.erf(_float(x)), 'erf')
erfinv = _unary(lambda x: torch.erfinv(_float(x)), 'erfinv')
floor = _unary(torch.floor, 'floor')
ceil = _unary(torch.ceil, 'ceil')
round = _unary(torch.round, 'round')
trunc = _unary(torch.trunc, 'trunc')
frac = _unary(lambda x: x - torch.trunc(x), 'frac')
reciprocal = _unary(lambda x: torch.reciprocal(_float(x)), 'reciprocal')
square = _unary(torch.square, 'square')
digamma = _unary(lambda x: torch.digamma(_float(x)), 'digamma')
lgamma = _unary(lambda x: torch.lgamma(_float(x)), 'lgamma')
i0 = _unary(lambda x: torch.special.i0(_float(x)), 'i0')
i1 = _unary(lambda x: torch.special.i1(_float(x)), 'i1')
sigmoid = _unary(lambda x: torch.sigmoid(_float(x)), 'sigmoid')
logit = defop(lambda x, eps=None: torch.logit(_float(x), eps), name='logit')
deg2rad = _unary(lambda x: torch.deg2rad(_float(x)), 'deg2rad')
rad2deg = _unary(lambda x: torch.rad2deg(_float(x)), 'rad2deg')
angle = _unary(torch.angle, 'angle')
conj = _unary(lambda x: torch.conj(x).resolve_conj(), 'conj')
real = _unary(lambda x: torch.real(x).clone() if x.is_complex() else x,
              'real')
imag = _unary(lambda x: torch.imag(x).clone() if x.is_complex()
              else torch.zeros_like(x), 'imag')
nan_to_num = defop(lambda x, nan=0.0, posinf=None, neginf=None:
                   torch.nan_to_num(x, nan=nan, posinf=posinf,
                                    neginf=neginf), name='nan_to_num')


def clip(x, min=None, max=None, name=None):
    return defop(lambda v, lo, hi: torch.clamp(v, lo, hi),
                 name='clip')(x, min, max)


def lerp(x, y, weight, name=None):
    return defop(lambda a, b, w: a + w * (b - a), name='lerp')(x, y, weight)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return defop(lambda v: scale_b * torch.tanh(scale_a * v),
                 name='stanh')(x)


def rsqrt_(x):
    return x._rebind(rsqrt(x))


# -- scale / increment -----------------------------------------------------

def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    def f(v, s, b):
        s = torch.as_tensor(s, dtype=v.dtype, device=v.device)
        b = torch.as_tensor(b, dtype=v.dtype, device=v.device)
        return v * s + b if bias_after_scale else (v + b) * s
    return defop(f, name='scale')(x, scale, bias)


def increment(x, value=1.0, name=None):
    return defop(lambda v: v + torch.as_tensor(value, dtype=v.dtype,
                                               device=v.device),
                 name='increment')(x)


# -- comparisons (outputs that stop the gradient) ------------------------

equal = _binary(torch.eq, 'equal')
not_equal = _binary(torch.ne, 'not_equal')
greater_than = _binary(torch.gt, 'greater_than')
greater_equal = _binary(torch.ge, 'greater_equal')
less_than = _binary(torch.lt, 'less_than')
less_equal = _binary(torch.le, 'less_equal')
equal_all = defop(lambda x, y: torch.tensor(
    tuple(x.shape) == tuple(y.shape) and bool(torch.equal(x, y.to(x.dtype))),
    device=x.device), name='equal_all')
allclose = defop(lambda x, y, rtol=1e-5, atol=1e-8, equal_nan=False:
                 torch.tensor(torch.allclose(*_pair(x, y), rtol=rtol,
                                             atol=atol, equal_nan=equal_nan),
                              device=x.device), name='allclose')
isclose = defop(lambda x, y, rtol=1e-5, atol=1e-8, equal_nan=False:
                torch.isclose(*_pair(x, y), rtol=rtol, atol=atol,
                              equal_nan=equal_nan), name='isclose')

logical_and = _binary(torch.logical_and, 'logical_and')
logical_or = _binary(torch.logical_or, 'logical_or')
logical_xor = _binary(torch.logical_xor, 'logical_xor')
logical_not = _unary(torch.logical_not, 'logical_not')

bitwise_and = _binary(torch.bitwise_and, 'bitwise_and')
bitwise_or = _binary(torch.bitwise_or, 'bitwise_or')
bitwise_xor = _binary(torch.bitwise_xor, 'bitwise_xor')
bitwise_not = _unary(torch.bitwise_not, 'bitwise_not')
bitwise_left_shift = _binary(torch.bitwise_left_shift, 'bitwise_left_shift')
bitwise_right_shift = _binary(torch.bitwise_right_shift,
                              'bitwise_right_shift')

isnan = _unary(torch.isnan, 'isnan')
isinf = _unary(torch.isinf, 'isinf')
isfinite = _unary(torch.isfinite, 'isfinite')
isreal = _unary(torch.isreal, 'isreal')


def tensordot(x, y, axes=2, name=None):
    """paddle.tensordot: contract over `axes` (an int, a list, or a pair
    of lists, as np.tensordot)."""
    if isinstance(axes, (list, tuple)) and len(axes) == 2 \
            and isinstance(axes[0], (list, tuple)):
        dims = (list(axes[0]), list(axes[1]))
    elif isinstance(axes, (list, tuple)):
        dims = (list(axes), list(axes))
    else:
        dims = int(axes)
    return defop(lambda a, b: torch.tensordot(a, b, dims=dims),
                 name='tensordot')(x, y)


def cdist(x, y, p=2.0, compute_mode='use_mm_for_euclid_dist_if_necessary',
          name=None):
    """Pairwise p-norm distances between the row vectors of the last two
    dims ([..., M, D] x [..., N, D] -> [..., M, N])."""
    def f(a, b):
        diff = a[..., :, None, :] - b[..., None, :, :]
        if p == 2.0:
            return torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))
        if p == float('inf'):
            return diff.abs().amax(-1)
        if p == 0:
            return (diff != 0).to(a.dtype).sum(-1)
        return diff.abs().pow(p).sum(-1).pow(1.0 / p)
    return defop(f, name='cdist')(x, y)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    def f(yv, *rest):
        if rest:
            return torch.trapezoid(yv, rest[0], dim=int(axis))
        return torch.trapezoid(yv, dx=1.0 if dx is None else dx,
                               dim=int(axis))
    return defop(f, name='trapezoid')(*((y,) if x is None else (y, x)))


def logcumsumexp(x, axis=None, dtype=None, name=None):
    def f(v):
        if dtype is not None:
            from ..dtype import convert_dtype
            v = v.to(convert_dtype(dtype))
        if axis is None:
            return torch.logcumsumexp(v.reshape(-1), 0)
        return torch.logcumsumexp(v, int(axis))
    return defop(f, name='logcumsumexp')(x)


def renorm(x, p, axis, max_norm, name=None):
    """Scale the slices along `axis` whose p-norm exceeds max_norm down to
    max_norm (paddle.renorm)."""
    def f(v):
        ax = int(axis) % v.dim()
        red = tuple(i for i in range(v.dim()) if i != ax)
        norms = (v.abs() ** p).sum(dim=red, keepdim=True) ** (1.0 / p)
        s = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                        torch.ones_like(norms))
        return v * s.to(v.dtype)
    return defop(f, name='renorm')(x)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return defop(lambda v: torch.diagonal(v, offset, axis1, axis2).sum(-1),
                 name='trace')(x)


def polygamma(x, n, name=None):
    return defop(lambda v: torch.polygamma(int(n), _float(v)),
                 name='polygamma')(x)


def signbit(x, name=None):
    return defop(torch.signbit, name='signbit')(x)


def isposinf(x, name=None):
    return defop(torch.isposinf, name='isposinf')(x)


def isneginf(x, name=None):
    return defop(torch.isneginf, name='isneginf')(x)


def positive(x, name=None):
    return defop(torch.positive, name='positive')(x)


def negative(x, name=None):
    return defop(torch.negative, name='negative')(x)


def multigammaln(x, p, name=None):
    """Log multivariate gamma (paddle.multigammaln)."""
    return defop(lambda v: torch.mvlgamma(_float(v), int(p)),
                 name='multigammaln')(x)


def sinc(x, name=None):
    return defop(lambda v: torch.sinc(_float(v)), name='sinc')(x)


def polar(abs, angle, name=None):
    return defop(torch.polar, name='polar')(abs, angle)


def nextafter(x, y, name=None):
    return _binary(torch.nextafter, 'nextafter')(x, y)


def ldexp(x, y, name=None):
    return _binary(lambda a, b: a * torch.pow(2.0, b).to(
        a.dtype if a.is_floating_point() else torch.float32), 'ldexp')(x, y)


def sgn(x, name=None):
    """Complex-aware sign: x / |x| for complex (0 where x == 0), sign for
    real (paddle.sgn)."""
    return defop(torch.sgn, name='sgn')(x)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    """The cumulative trapezoidal integral along `axis`."""
    def f(yv, *rest):
        if rest:
            xv = rest[0]
            if xv.dim() != yv.dim():
                ax = int(axis) % yv.dim()
                shape = [1] * yv.dim()
                shape[ax] = -1
                xv = xv.reshape(shape).expand_as(yv)
            return torch.cumulative_trapezoid(yv, xv, dim=int(axis))
        return torch.cumulative_trapezoid(yv, dx=1.0 if dx is None else dx,
                                          dim=int(axis))
    return defop(f, name='cumulative_trapezoid')(
        *((y,) if x is None else (y, x)))


def complex(real, imag, name=None):
    return defop(torch.complex, name='complex')(real, imag)


def is_complex(x) -> builtins.bool:
    return to_torch(x).is_complex()


def is_floating_point(x) -> builtins.bool:
    return to_torch(x).is_floating_point()


def is_integer(x) -> builtins.bool:
    v = to_torch(x)
    return not (v.is_floating_point() or v.is_complex()
                or v.dtype == torch.bool)
