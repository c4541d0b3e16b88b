"""paddle_tpu_torch.analysis.runtime: runtime sanitizers (counterpart of
`paddle_tpu/analysis/runtime`).

`concurrency` is the first: instrumented lock wrappers feeding a
process-global acquisition graph (lockdep-style cycle/re-entry
detection) plus an Eraser-style `guarded_by` lockset race checker.
Everything here is stdlib-only at import time: the metrics registry
itself allocates its lock through these wrappers.
"""
from .concurrency import (  # noqa: F401
    KIND_LOCK_ORDER,
    KIND_LOCKSET,
    KIND_REENTRY,
    KINDS,
    Condition,
    ConcurrencySanitizerError,
    Lock,
    RLock,
    SanitizedCondition,
    SanitizedLock,
    SanitizedRLock,
    disable,
    enable,
    guarded_by,
    mode,
    reset,
    sanitized,
    stats,
    violations,
)
