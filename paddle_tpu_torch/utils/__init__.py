"""Utilities (counterpart of `paddle_tpu.utils`): step-indexed checkpoints
(`CheckpointManager`, with the native sharded backend over
`ckpt_native`), the JSONL metric log (`logging.SummaryWriter`), the
`flops` module (`flops` / `summary`, exported at the top level),
`unique_name`, `try_import` and `deprecated`.
`run_check` waits for `distributed/` (it runs a collective over every
local device)."""
from . import flops  # noqa: F401
from . import logging
from . import unique_name
from .checkpoint import CheckpointManager


def try_import(module_name, err_msg=None):
    """Import a module or raise with an install hint (upstream
    paddle.utils.try_import)."""
    import importlib
    try:
        return importlib.import_module(module_name)
    except ImportError as e:
        raise ImportError(
            err_msg or f'{module_name} is required for this API; '
                       f'install it first') from e


def deprecated(update_to='', since='', reason='', level=0):
    """Decorator stamping a DeprecationWarning on calls (upstream
    paddle.utils.deprecated)."""
    import functools
    import warnings

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            msg = f'API {fn.__name__} is deprecated'
            if since:
                msg += f' since {since}'
            if update_to:
                msg += f'; use {update_to} instead'
            if reason:
                msg += f' ({reason})'
            warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return fn(*args, **kwargs)
        return wrapper
    return deco


__all__ = ['CheckpointManager', 'deprecated', 'flops', 'logging',
           'try_import', 'unique_name']
