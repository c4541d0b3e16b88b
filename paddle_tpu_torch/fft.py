"""paddle.fft (counterpart of `paddle_tpu/fft.py`): the transforms over
`torch.fft`, each an op through `tensor.apply_op` (differentiable by
torch's autograd). A complex128 or float64 input stays 64-bit (the
port's rule for 64-bit dtypes); `norm` takes 'backward', 'forward' or
'ortho' as in numpy."""
from __future__ import annotations

import torch

from . import framework
from .dtype import to_torch_dtype
from .ops._helpers import defop
from .tensor import Tensor

__all__ = ['fft', 'ifft', 'rfft', 'irfft', 'hfft', 'ihfft',
           'fft2', 'ifft2', 'rfft2', 'irfft2',
           'fftn', 'ifftn', 'rfftn', 'irfftn',
           'fftshift', 'ifftshift', 'fftfreq', 'rfftfreq']


def _wrap1(tfn, name):
    def op(x, n=None, axis=-1, norm='backward', name_=None):
        return defop(lambda v: tfn(v, n=n, dim=axis, norm=norm),
                     name=name)(x)
    op.__name__ = name
    return op


def _wrap2(tfn, name):
    def op(x, s=None, axes=(-2, -1), norm='backward', name_=None):
        return defop(lambda v: tfn(v, s=s, dim=tuple(axes), norm=norm),
                     name=name)(x)
    op.__name__ = name
    return op


def _wrapn(tfn, name):
    def op(x, s=None, axes=None, norm='backward', name_=None):
        ax = tuple(axes) if axes is not None else None
        return defop(lambda v: tfn(v, s=s, dim=ax, norm=norm),
                     name=name)(x)
    op.__name__ = name
    return op


fft = _wrap1(torch.fft.fft, 'fft')
ifft = _wrap1(torch.fft.ifft, 'ifft')
rfft = _wrap1(torch.fft.rfft, 'rfft')
irfft = _wrap1(torch.fft.irfft, 'irfft')
hfft = _wrap1(torch.fft.hfft, 'hfft')
ihfft = _wrap1(torch.fft.ihfft, 'ihfft')
fft2 = _wrap2(torch.fft.fft2, 'fft2')
ifft2 = _wrap2(torch.fft.ifft2, 'ifft2')
rfft2 = _wrap2(torch.fft.rfft2, 'rfft2')
irfft2 = _wrap2(torch.fft.irfft2, 'irfft2')
fftn = _wrapn(torch.fft.fftn, 'fftn')
ifftn = _wrapn(torch.fft.ifftn, 'ifftn')
rfftn = _wrapn(torch.fft.rfftn, 'rfftn')
irfftn = _wrapn(torch.fft.irfftn, 'irfftn')


def _axes(axes):
    return tuple(axes) if isinstance(axes, (list, tuple)) else axes


def fftshift(x, axes=None, name=None):
    return defop(lambda v: torch.fft.fftshift(v, dim=_axes(axes)),
                 name='fftshift')(x)


def ifftshift(x, axes=None, name=None):
    return defop(lambda v: torch.fft.ifftshift(v, dim=_axes(axes)),
                 name='ifftshift')(x)


def _freqs(tfn, n, d, dtype):
    out = tfn(int(n), d=float(d), device=framework.current_device())
    return Tensor(out.to(to_torch_dtype(dtype)) if dtype else out)


def fftfreq(n, d=1.0, dtype=None, name=None):
    """Sample frequencies of an n-point transform, on the current place
    (float32 unless `dtype`)."""
    return _freqs(torch.fft.fftfreq, n, d, dtype)


def rfftfreq(n, d=1.0, dtype=None, name=None):
    return _freqs(torch.fft.rfftfreq, n, d, dtype)
