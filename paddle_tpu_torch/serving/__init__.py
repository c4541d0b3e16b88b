"""Serving (counterpart of `paddle_tpu.serving`): the paged
continuous-batching `InferenceEngine`, its request API and multi-tenant
LoRA adapters (`AdapterBank`)."""
from .adapters import AdapterBank, AdapterUnavailable, make_adapter_factors
from .api import (FAILED, FINISHED, GREEDY, PRIORITY_HIGH, PRIORITY_LOW,
                  PRIORITY_NORMAL, QUEUED, RUNNING, SAMPLING,
                  RequestHandle, SamplingParams)
from .decode_graph import sample_rows
from .engine import InferenceEngine
from .kv_pool import (PagedSlotPool, PagePoolExhausted, PromptTooLongError,
                      default_buckets, scatter_pages)
from .scheduler import FCFSScheduler

__all__ = ['FAILED', 'FINISHED', 'GREEDY', 'PRIORITY_HIGH', 'PRIORITY_LOW',
           'PRIORITY_NORMAL', 'QUEUED', 'RUNNING',
           'SAMPLING', 'RequestHandle', 'SamplingParams', 'InferenceEngine',
           'sample_rows', 'PagedSlotPool', 'PagePoolExhausted',
           'PromptTooLongError', 'default_buckets', 'scatter_pages',
           'FCFSScheduler', 'AdapterBank', 'AdapterUnavailable',
           'make_adapter_factors']
