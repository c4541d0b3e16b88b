"""paddle.amp.debugging (counterpart of `paddle_tpu/amp/debugging.py`):
numerical-health tools for mixed-precision runs.

The tensor checker is `debug.enable_check_numerics` (a scan of every op
output at the choke point); the operator stats ride the same hook."""
from __future__ import annotations

import collections
from typing import Optional

from .. import debug as _debug


class DebugMode:
    """Check granularity (paddle.amp.debugging.DebugMode)."""
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 2


def enable_tensor_checker(checker_config=None):
    """Scan every op output for NaN/Inf (enable_tensor_checker; through
    debug.enable_check_numerics)."""
    _debug.enable_check_numerics()


def disable_tensor_checker():
    _debug.disable_check_numerics()


def check_numerics(tensor, op_type: str = 'tensor', stack_height_limit=1,
                   debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT):
    """One NaN/Inf check of a tensor (paddle.amp.debugging.check_numerics)."""
    return _debug.check_numerics(
        tensor, name=op_type,
        raise_on_error=(debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT))


_op_stats: Optional[dict] = None
_prev_hook = None


def enable_operator_stats_collection():
    """Start counting calls and output dtypes per op; chains with (does
    not replace) an active NaN/Inf checker."""
    global _op_stats, _prev_hook
    from .. import tensor as tmod
    if _op_stats is not None:
        _op_stats.clear()
        return
    _op_stats = collections.defaultdict(
        lambda: {'calls': 0, 'dtypes': collections.Counter()})
    _prev_hook = tmod._numerics_hook

    def hook(out, op_name):
        if _prev_hook is not None:
            _prev_hook(out, op_name)
        rec = _op_stats[op_name]
        rec['calls'] += 1
        for leaf in (out if isinstance(out, (tuple, list)) else [out]):
            dt = getattr(leaf, 'dtype', None)
            if dt is not None:
                rec['dtypes'][str(dt).replace('torch.', '')] += 1
    tmod._numerics_hook = hook


def disable_operator_stats_collection():
    """Stop collecting and print the per-op dtype table."""
    global _op_stats, _prev_hook
    from .. import tensor as tmod
    tmod._numerics_hook = _prev_hook
    _prev_hook = None
    if _op_stats is None:
        return
    lines = [f'{"op":<32}{"calls":>8}  dtypes']
    for name, rec in sorted(_op_stats.items()):
        dts = ', '.join(f'{d}x{c}' for d, c in rec['dtypes'].items())
        lines.append(f'{name:<32}{rec["calls"]:>8}  {dts}')
    print('\n'.join(lines))
    _op_stats = None


def collect_operator_numerical_stats():
    """A snapshot of the collected stats."""
    return {k: {'calls': v['calls'], 'dtypes': dict(v['dtypes'])}
            for k, v in (_op_stats or {}).items()}
