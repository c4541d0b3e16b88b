"""Multi-tenant LoRA adapter serving (counterpart of
`paddle_tpu.serving.adapters`): one base model and many per-tenant
adapters, decoded together in one batch.

- `bank.AdapterBank`: fixed-capacity packed A/B factor banks per target
  projection on the model's device, with a host-side slot table
  (reference-count pinning, LRU eviction).
- `apply.adapter_scope` / `apply.linear_hook`: per-row bank slots flow
  as a tensor into each forward, and every adapted projection adds its
  delta through the `adapter_matmul_add` kernel (delta and add in one
  pass).

    from paddle_tpu_torch.serving import AdapterBank, InferenceEngine
    bank = AdapterBank(model, capacity=8, rank=8,
                       targets=('q_proj', 'k_proj', 'v_proj', 'o_proj'))
    bank.load('tenant-a', factors_a)
    eng = InferenceEngine(model, num_slots=8, adapter_bank=bank)
    h = eng.submit(prompt, params, adapter_id='tenant-a')
"""
from __future__ import annotations

from .apply import adapter_scope, linear_hook
from .bank import (AdapterBank, AdapterUnavailable, DEFAULT_TARGETS,
                   make_adapter_factors)

__all__ = [
    'AdapterBank', 'AdapterUnavailable', 'DEFAULT_TARGETS',
    'adapter_scope', 'linear_hook', 'make_adapter_factors',
]
