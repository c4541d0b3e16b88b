"""Serving (counterpart of `paddle_tpu.serving`): the continuous-batching
`InferenceEngine` over one KV row per slot (`SlotPool`, the default) or
a page table (`PagedSlotPool`, with `kv_page_size`, `kv_pages` or
`kv_quant`), its request API, the radix prefix cache over retained rows
(`RadixPrefixCache`) or shared pages (`PagedPrefixCache`), multi-tenant
LoRA adapters
(`AdapterBank`), versioned weights (`WeightStore`, `WeightPublisher`, the
swap's health gates and the rolling `ReplicaUpdater`), and replicated
serving in one process: a `Router` over a `ReplicaSet` with
least-loaded placement, failover behind per-replica circuit breakers and
per-tenant QoS (`tenancy.py`), and the goodput-driven `Autoscaler`;
and the process fleet: a `Supervisor` spawns replica processes
(`python -m paddle_tpu_torch.serving.replica_main`, each its own engine
over the weight store's version, its graphs captured before it binds)
and the Router places requests on each through a `RemoteReplica` over a
checksummed framed RPC socket (`remote.py`).

    from paddle_tpu_torch.serving import ReplicaSet, Router
    router = Router(ReplicaSet(model, 2, num_slots=8, max_length=256),
                    tenants='paid:priority=high;free:priority=low,rate=2',
                    shed_queue_depth=64)
    h = router.submit(prompt_ids, tenant='paid')

    spec = ReplicaSpec('my_models.py:llama', engine_kwargs=dict(
        num_slots=8, max_length=1024), weight_store_dir='/fleet/weights',
        spool_dir='/fleet/spool')
    sup = Supervisor('/fleet/run', spec)
    router = Router([Replica(0, sup.spawn()), Replica(1, sup.spawn())])

Each in-process replica past the first serves its own copy of the
weights (`router.replica_model`): a swap copies into its engine's
parameters in place. A replica process loads its weights from the store
and swaps by version."""
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
                      PromptTooLongError, SlotPool, default_buckets,
                      gather_pages, scatter_pages)
from .prefix_cache import PagedPrefixCache, RadixPrefixCache
from .remote import (FrameChecksumError, IncompleteFrameError,
                     RemoteFatalError, RemoteReplica, RemoteTransientError,
                     RpcClient)
from .router import (CircuitBreaker, Replica, ReplicaFailure, ReplicaSet,
                     Router, RouterHandle, replica_model)
from .scheduler import FCFSScheduler
from .supervisor import ReplicaSpec, Supervisor
from .tenancy import (AdmissionRejected, Tenant, TenantRegistry,
                      TokenBucket, estimate_queue_rounds,
                      parse_tenant_spec, prefill_rounds)

__all__ = ['FAILED', 'FINISHED', 'GREEDY', 'PRIORITY_HIGH', 'PRIORITY_LOW',
           'PRIORITY_NAMES', 'PRIORITY_NORMAL', 'QUEUED', 'RUNNING',
           'SAMPLING', 'RequestHandle', 'SamplingParams', 'InferenceEngine',
           'sample_rows', 'PageHold', 'PagedSlotPool', 'PagePoolExhausted',
           'SlotPool',
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
           'Autoscaler', 'AutoscalerConfig',
           'RemoteReplica', 'RpcClient', 'IncompleteFrameError',
           'FrameChecksumError', 'RemoteTransientError', 'RemoteFatalError',
           'ReplicaSpec', 'Supervisor']
