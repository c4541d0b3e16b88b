"""Global FLAGS_* registry (counterpart of `paddle_tpu/flags.py`; upstream:
paddle/phi/core/flags.cc, paddle.get_flags).

A copy of the JAX package's dict-backed registry with the same names,
defaults and getter/setter API. In the port the fault-tolerance flags are
read by `resilience/retry.py` (`FLAGS_ft_max_retries` and the backoff
delays); the others are kept for API parity.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterable, List, Optional, Union

_FLAGS: Dict[str, Any] = {
    # determinism (the JAX package's defaults)
    'FLAGS_deterministic': True,
    'FLAGS_cudnn_deterministic': True,
    'FLAGS_embedding_deterministic': 1,
    # numerics monitoring
    'FLAGS_check_nan_inf': False,
    'FLAGS_check_nan_inf_level': 0,
    # allocator knobs, kept for API parity
    'FLAGS_fraction_of_gpu_memory_to_use': 0.92,
    'FLAGS_allocator_strategy': 'auto_growth',
    'FLAGS_eager_delete_tensor_gb': 0.0,
    # fault tolerance (the retry budget and delays: resilience/retry.py)
    'FLAGS_resilience': True,          # master gate for FT instrumentation
    'FLAGS_ft_max_retries': 3,         # transient-error retry budget
    'FLAGS_ft_retry_base_delay': 0.1,  # first backoff sleep (seconds)
    'FLAGS_ft_retry_max_delay': 30.0,  # backoff cap (seconds)
    'FLAGS_ft_skip_budget': 10,        # bad steps a run may drop
    'FLAGS_ft_snapshot_interval': 1,   # steps between rollback snapshots
    'FLAGS_ft_step_deadline_s': 0.0,   # watchdog deadline; 0 = disabled
    # misc parity flags
    'FLAGS_use_mkldnn': False,
    'FLAGS_paddle_num_threads': 1,
    'FLAGS_benchmark': False,
    'FLAGS_cudnn_exhaustive_search': False,
    'FLAGS_conv_workspace_size_limit': 512,
    'FLAGS_max_inplace_grad_add': 0,
    'FLAGS_log_level': 0,
}


def _canon(name: str) -> str:
    return name if name.startswith('FLAGS_') else 'FLAGS_' + name


def get_flags(flags: Optional[Union[str, Iterable[str]]] = None) -> Dict[str, Any]:
    """Return {flag: value}. `flags` may be one name, a list, or None (all)."""
    if flags is None:
        return dict(_FLAGS)
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for f in flags:
        key = _canon(f)
        if key not in _FLAGS:
            raise ValueError(f'Flag {f!r} is not registered')
        out[key] = _FLAGS[key]
    return out


def set_flags(flags: Dict[str, Any]) -> None:
    """Set registered flags from a {name: value} dict."""
    if not isinstance(flags, dict):
        raise TypeError('set_flags expects a dict of {flag_name: value}')
    for f, v in flags.items():
        key = _canon(f)
        if key not in _FLAGS:
            raise ValueError(f'Flag {f!r} is not registered')
        _FLAGS[key] = v


def register_flag(name: str, default: Any) -> None:
    """Register a new flag (env var FLAGS_x overrides the default)."""
    key = _canon(name)
    if key in _FLAGS:
        return
    env = os.environ.get(key)
    if env is None:
        _FLAGS[key] = default
    elif isinstance(default, bool):
        _FLAGS[key] = env.strip().lower() in ('1', 'true', 'yes', 'on')
    elif isinstance(default, (int, float)):
        _FLAGS[key] = type(default)(env)
    else:
        _FLAGS[key] = env


def flag(name: str) -> Any:
    """Internal fast-path getter."""
    return _FLAGS[_canon(name)]
