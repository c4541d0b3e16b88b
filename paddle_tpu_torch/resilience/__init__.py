"""Resilience (counterpart of `paddle_tpu.resilience`): transient-error
retry with backoff (`retry`, `RetryPolicy`, `is_transient`), which the
checkpoint and weight-store I/O runs through, and the preemption handler
the serving engine's graceful drain listens to.

Not ported yet (ROADMAP.md, Queue 1, item 3): `FaultTolerantStep`,
`StepWatchdog` and the elastic train step and loop."""
from .preemption import PreemptionHandler
from .retry import (FatalError, RetryPolicy, TransientError,
                    call_with_retry, exception_chain, is_cuda_error,
                    is_transient, register_transient, retry)

__all__ = ['FatalError', 'RetryPolicy', 'TransientError', 'call_with_retry',
           'exception_chain', 'is_cuda_error', 'is_transient',
           'register_transient', 'retry', 'PreemptionHandler']
