"""Serving (counterpart of `paddle_tpu.serving`): the paged
continuous-batching `InferenceEngine`, its request API, the radix prefix
cache over shared pages (`PagedPrefixCache`), multi-tenant LoRA adapters
(`AdapterBank`) and versioned weights (`WeightStore`, `WeightPublisher`
and the swap's health gates)."""
from .adapters import AdapterBank, AdapterUnavailable, make_adapter_factors
from .api import (FAILED, FINISHED, GREEDY, PRIORITY_HIGH, PRIORITY_LOW,
                  PRIORITY_NORMAL, QUEUED, RUNNING, SAMPLING,
                  RequestHandle, SamplingParams)
from .decode_graph import sample_rows
from .engine import InferenceEngine
from .hotswap import (CanaryGate, SwapFailed, WeightLoadError,
                      WeightPublisher, WeightStore, finite_weights_gate)
from .kv_pool import (PageHold, PagedSlotPool, PagePoolExhausted,
                      PromptTooLongError, default_buckets, gather_pages,
                      scatter_pages)
from .prefix_cache import PagedPrefixCache, RadixPrefixCache
from .scheduler import FCFSScheduler

__all__ = ['FAILED', 'FINISHED', 'GREEDY', 'PRIORITY_HIGH', 'PRIORITY_LOW',
           'PRIORITY_NORMAL', 'QUEUED', 'RUNNING',
           'SAMPLING', 'RequestHandle', 'SamplingParams', 'InferenceEngine',
           'sample_rows', 'PageHold', 'PagedSlotPool', 'PagePoolExhausted',
           'PromptTooLongError', 'default_buckets', 'gather_pages',
           'scatter_pages', 'PagedPrefixCache', 'RadixPrefixCache',
           'FCFSScheduler', 'AdapterBank', 'AdapterUnavailable',
           'make_adapter_factors', 'CanaryGate', 'SwapFailed',
           'WeightLoadError', 'WeightPublisher', 'WeightStore',
           'finite_weights_gate']
