"""Transient-error retry: classifier + exponential backoff with jitter
(counterpart of `paddle_tpu/resilience/retry.py`).

Checkpoint and weight-store I/O sheds transient failures (a flaky mount,
a dropped connection) that a run must absorb, while fatal errors (shape
mismatches, assertion failures, a dead CUDA context) must surface at
once. This module is the one place that judgment lives:

- `is_transient(exc)`: type-based first (ConnectionError/TimeoutError/
  `TransientError`), then message-based against the status vocabulary of
  the JAX package (RESOURCE_EXHAUSTED, UNAVAILABLE, DEADLINE_EXCEEDED,
  ...); extendable with `register_transient`. One difference from the
  JAX function: a CUDA error anywhere in the chain (`is_cuda_error`) is
  never transient. CUDA's "the launch timed out and was terminated" and
  "CUDA-capable device(s) is/are busy or unavailable" match the markers
  'timed out' and 'unavailable', but both leave the context dead, and a
  retry would spin on it. On every other exception the answer equals
  the JAX function's.
- `RetryPolicy`: max_retries / exponential backoff / jitter, defaulting
  from the FLAGS_ft_* registry (`flags.py`).
- `retry(policy, site)` and `call_with_retry(fn, ...)`: the wrappers
  around checkpoint and weight-store I/O.

Not ported yet (ROADMAP.md, Queue 1, item 2): the JAX module's retry
notes (the `paddle_resilience_retries_total{site}` counter, the `retry`
event) and the `resilience.backoff` span around each sleep.
"""
from __future__ import annotations

import functools
import random
import socket
import time
from typing import Any, Callable, Optional, Tuple, Type

from .. import flags as _flags


class TransientError(RuntimeError):
    """Marker exception that is always classified as retryable (used by
    tests and as a base class for custom transient failures)."""


class FatalError(RuntimeError):
    """Marker exception that is never retried, even if its message
    matches a transient pattern."""


# the JAX package's vocabulary (status names + socket-level suspects),
# matched case-insensitively against "TypeName: message"
_TRANSIENT_MARKERS: Tuple[str, ...] = (
    'resource_exhausted',
    'resource exhausted',
    'deadline_exceeded',
    'deadline exceeded',
    'unavailable',
    'aborted',
    'cancelled',
    'data_loss',
    'connection reset',
    'connection refused',
    'connection closed',
    'broken pipe',
    'temporarily unavailable',
    'try again',
    'socket closed',
    'transport closed',
    'compile timeout',
    'compilation timed out',
    'preempted',
    'incomplete frame',
    'frame sha256 mismatch',
    'connection aborted',
    'timed out',
)

# listed explicitly, as in the JAX package: subclass drift in a future
# stdlib must not change the classification
_transient_types: Tuple[Type[BaseException], ...] = (
    TransientError, ConnectionError, TimeoutError, InterruptedError,
    ConnectionResetError, BrokenPipeError, ConnectionRefusedError,
    ConnectionAbortedError, socket.timeout,
)


def register_transient(exc_type: Type[BaseException]):
    """Teach the classifier a new retryable exception type (e.g. a cloud
    storage client's throttling error, or a test's injected fault)."""
    global _transient_types
    if exc_type not in _transient_types:
        _transient_types = _transient_types + (exc_type,)
    return exc_type


# chain walk bounds: real chains are 2-3 deep; the cap guards against a
# pathological graph (and the id-set against __context__ cycles)
_CHAIN_LIMIT = 16

_NEVER_TRANSIENT = (KeyboardInterrupt, SystemExit, GeneratorExit)
_PROGRAMMING_ERRORS = (AssertionError, TypeError, ValueError, KeyError,
                       AttributeError, NotImplementedError)


def is_cuda_error(exc: BaseException) -> bool:
    """A CUDA error, PyTorch's (`torch.AcceleratorError`, or a
    RuntimeError whose text holds 'CUDA error') or a kernel wrapper's
    (which raise with the same text). Such an error is sticky: the
    context is dead for this process. The serving engine treats it as
    fatal to the engine, and `is_transient` never retries it."""
    return 'CUDA error' in str(exc) or \
        type(exc).__name__ == 'AcceleratorError'


def exception_chain(exc: BaseException):
    """Yield `exc` and its `__cause__`/`__context__` ancestry, outermost
    first. Follows `raise X from Y` (`__cause__`) when explicit,
    otherwise the implicit `__context__` unless suppressed
    (`raise X from None`). Cycle-safe and depth-bounded."""
    seen = set()
    depth = 0
    while (exc is not None and id(exc) not in seen
           and depth < _CHAIN_LIMIT):
        seen.add(id(exc))
        depth += 1
        yield exc
        if exc.__cause__ is not None:
            exc = exc.__cause__
        elif not exc.__suppress_context__:
            exc = exc.__context__
        else:
            exc = None


def is_transient(exc: BaseException) -> bool:
    """True if `exc` looks like a failure that a bounded retry can
    outlive. Walks the `__cause__`/`__context__` chain: a transient error
    wrapped in another exception is still transient, while a FatalError,
    a KeyboardInterrupt/SystemExit/GeneratorExit or a CUDA error anywhere
    in the chain makes the whole chain fatal. A programming error
    (TypeError, ValueError, KeyError, ...) never matches by its own
    message."""
    for e in exception_chain(exc):
        if isinstance(e, (FatalError,) + _NEVER_TRANSIENT) or \
                is_cuda_error(e):
            return False
    for e in exception_chain(exc):
        if isinstance(e, _PROGRAMMING_ERRORS):
            continue   # a caller bug never matches, even by message
        if isinstance(e, _transient_types):
            return True
        msg = f'{type(e).__name__}: {e}'.lower()
        if any(marker in msg for marker in _TRANSIENT_MARKERS):
            return True
    return False


class RetryPolicy:
    """Exponential backoff with +/- jitter over a transient classifier.

    max_retries counts *re*-attempts: max_retries=3 means up to 4 calls.
    delay(attempt) = min(base * multiplier**attempt, max_delay), scaled
    by a uniform factor in [1 - jitter, 1 + jitter] so hosts retrying
    the same shared service do not stampede in lockstep. Defaults come
    from the FLAGS_ft_* registry; `classify` overrides the
    transient/fatal judgment per call site.
    """

    def __init__(self, max_retries: Optional[int] = None,
                 base_delay: Optional[float] = None,
                 max_delay: Optional[float] = None,
                 multiplier: float = 2.0, jitter: float = 0.25,
                 classify: Optional[Callable[[BaseException], bool]] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.max_retries = int(_flags.flag('FLAGS_ft_max_retries')
                               if max_retries is None else max_retries)
        self.base_delay = float(_flags.flag('FLAGS_ft_retry_base_delay')
                                if base_delay is None else base_delay)
        self.max_delay = float(_flags.flag('FLAGS_ft_retry_max_delay')
                               if max_delay is None else max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.classify = classify or is_transient
        self.sleep = sleep

    def delay(self, attempt: int) -> float:
        """Backoff before re-attempt number `attempt` (0-based)."""
        d = min(self.base_delay * self.multiplier ** attempt,
                self.max_delay)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * random.random() - 1.0)
        return max(d, 0.0)

    def retryable(self, exc: BaseException) -> bool:
        return self.classify(exc)


def call_with_retry(fn: Callable, *args, policy: Optional[RetryPolicy] = None,
                    site: str = 'generic', **kwargs) -> Any:
    """Run `fn(*args, **kwargs)`, re-attempting transient failures per
    `policy`. Fatal errors and exhausted budgets re-raise the original
    exception unchanged. `site` names the call site (the JAX package
    labels its retry notes with it)."""
    policy = policy or RetryPolicy()
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except BaseException as exc:
            if attempt >= policy.max_retries or not policy.retryable(exc):
                raise
            d = policy.delay(attempt)
            if d > 0:
                policy.sleep(d)
            attempt += 1


def retry(policy: Optional[RetryPolicy] = None, site: Optional[str] = None):
    """Decorator form: `@retry(RetryPolicy(max_retries=5), site='io')`.
    Also usable bare (`@retry()`) with the flag-default policy; `site`
    defaults to the function name."""
    def deco(fn):
        label = site or fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return call_with_retry(fn, *args, policy=policy, site=label,
                                   **kwargs)
        return wrapper
    return deco
