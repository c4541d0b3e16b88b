"""Serving (counterpart of `paddle_tpu.serving`): the paged
continuous-batching `InferenceEngine`, its request API, the radix prefix
cache over shared pages (`PagedPrefixCache`), multi-tenant LoRA adapters
(`AdapterBank`), versioned weights (`WeightStore`, `WeightPublisher`, the
swap's health gates and the rolling `ReplicaUpdater`), and replicated
serving in one process: a `Router` over a `ReplicaSet` with
least-loaded placement, failover behind per-replica circuit breakers and
per-tenant QoS (`tenancy.py`), and the goodput-driven `Autoscaler`.

    from paddle_tpu_torch.serving import ReplicaSet, Router
    router = Router(ReplicaSet(model, 2, num_slots=8, max_length=256),
                    tenants='paid:priority=high;free:priority=low,rate=2',
                    shed_queue_depth=64)
    h = router.submit(prompt_ids, tenant='paid')

Each replica past the first serves its own copy of the weights
(`router.replica_model`): a swap copies into its engine's parameters in
place. The process fleet of the JAX package (`remote.py`,
`replica_main.py`, `supervisor.py`) is not ported yet (ROADMAP.md,
Queue 1)."""
from .adapters import AdapterBank, AdapterUnavailable, make_adapter_factors
from .api import (FAILED, FINISHED, GREEDY, PRIORITY_HIGH, PRIORITY_LOW,
                  PRIORITY_NAMES, PRIORITY_NORMAL, QUEUED, RUNNING,
                  SAMPLING, RequestHandle, SamplingParams)
from .autoscaler import Autoscaler, AutoscalerConfig
from .decode_graph import sample_rows
from .engine import InferenceEngine
from .hotswap import (CanaryGate, ReplicaUpdater, SwapFailed,
                      WeightLoadError, WeightPublisher, WeightStore,
                      finite_weights_gate)
from .kv_pool import (PageHold, PagedSlotPool, PagePoolExhausted,
                      PromptTooLongError, default_buckets, gather_pages,
                      scatter_pages)
from .prefix_cache import PagedPrefixCache, RadixPrefixCache
from .router import (CircuitBreaker, Replica, ReplicaFailure, ReplicaSet,
                     Router, RouterHandle, replica_model)
from .scheduler import FCFSScheduler
from .tenancy import (AdmissionRejected, Tenant, TenantRegistry,
                      TokenBucket, estimate_queue_rounds,
                      parse_tenant_spec, prefill_rounds)

__all__ = ['FAILED', 'FINISHED', 'GREEDY', 'PRIORITY_HIGH', 'PRIORITY_LOW',
           'PRIORITY_NAMES', 'PRIORITY_NORMAL', 'QUEUED', 'RUNNING',
           'SAMPLING', 'RequestHandle', 'SamplingParams', 'InferenceEngine',
           'sample_rows', 'PageHold', 'PagedSlotPool', 'PagePoolExhausted',
           'PromptTooLongError', 'default_buckets', 'gather_pages',
           'scatter_pages', 'PagedPrefixCache', 'RadixPrefixCache',
           'FCFSScheduler', 'AdapterBank', 'AdapterUnavailable',
           'make_adapter_factors', 'CanaryGate', 'ReplicaUpdater',
           'SwapFailed', 'WeightLoadError', 'WeightPublisher', 'WeightStore',
           'finite_weights_gate',
           'CircuitBreaker', 'Replica', 'ReplicaFailure', 'ReplicaSet',
           'Router', 'RouterHandle', 'replica_model',
           'AdmissionRejected', 'Tenant', 'TenantRegistry', 'TokenBucket',
           'parse_tenant_spec', 'prefill_rounds', 'estimate_queue_rounds',
           'Autoscaler', 'AutoscalerConfig']
