"""Op-definition helpers: torch functions as Paddle ops (counterpart of
`paddle_tpu/ops/_helpers.py`)."""
from __future__ import annotations

import functools

from ..tensor import apply_op


def defop(fn=None, *, name=None):
    """Decorator: `fn` is written against torch tensors; the wrapper
    accepts Tensors anywhere, runs through `apply_op` under the op's name
    (the name AMP casts by) and takes Paddle's trailing `name=`."""
    def deco(f):
        opname = name or f.__name__

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            kwargs.pop('name', None)
            return apply_op(f, *args, _name=opname, **kwargs)
        wrapper.__wrapped_torch__ = f
        return wrapper
    return deco(fn) if fn is not None else deco

