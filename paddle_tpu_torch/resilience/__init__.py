"""Resilience (counterpart of `paddle_tpu.resilience`): transient-error
retry with backoff (`retry`, `RetryPolicy`, `is_transient`), which the
checkpoint and weight-store I/O runs through; the preemption handler the
serving engine's graceful drain and `hapi.Model.fit` listen to; the
fault-tolerant train step (`FaultTolerantStep`: snapshot, rollback and
skip of a NaN or loss-spike batch within a skip budget) and the step
watchdog (`StepWatchdog`).

Not ported yet (ROADMAP.md, Queue 1): the elastic train step and loop
(`resilience/elastic.py`), which wait for `distributed/`."""
from .preemption import PreemptionHandler
from .retry import (FatalError, RetryPolicy, TransientError,
                    call_with_retry, exception_chain, is_cuda_error,
                    is_transient, register_transient, retry)
from .step import FaultTolerantStep, SkipBudgetExhausted
from .watchdog import StepWatchdog

__all__ = ['FatalError', 'RetryPolicy', 'TransientError', 'call_with_retry',
           'exception_chain', 'is_cuda_error', 'is_transient',
           'register_transient', 'retry', 'PreemptionHandler',
           'FaultTolerantStep', 'SkipBudgetExhausted', 'StepWatchdog']
