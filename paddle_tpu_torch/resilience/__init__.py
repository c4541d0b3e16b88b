"""Resilience (counterpart of `paddle_tpu.resilience`): the preemption
handler the serving engine's graceful drain listens to."""
from .preemption import PreemptionHandler

__all__ = ['PreemptionHandler']
