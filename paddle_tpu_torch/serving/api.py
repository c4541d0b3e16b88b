"""Serving user API: per-request sampling params + request handles
(counterpart of `paddle_tpu/serving/api.py`).

The continuous-batching engine (engine.py) is iteration-level: requests
enter and leave the running batch between decode rounds (Orca, Yu et al.
OSDI'22), so the unit of user interaction is a `RequestHandle` — a live
view of one request's tokens/status that the caller can poll, `stream()`
per token, or block on with `result()`. `SamplingParams` is plain data;
the engine lowers it into per-slot tensors so one decode round serves
heterogeneous requests. A handle's `request_id` is its `trace_id`: the
engine threads it through the request's spans and events, and its
request-ledger record (`_ledger_rec`) marks the first token and closes
when the request finishes or fails.
"""
from __future__ import annotations

import itertools
import time
from typing import List, Optional

from ..observability import reqledger as _reqledger

GREEDY = 'greedy_search'
SAMPLING = 'sampling'

# priority classes (lower = more urgent); the scheduler orders admission
# by (priority, FCFS-within-class); the router maps tenants onto these
PRIORITY_HIGH = 0
PRIORITY_NORMAL = 1
PRIORITY_LOW = 2
PRIORITY_NAMES = {'high': PRIORITY_HIGH, 'normal': PRIORITY_NORMAL,
                  'low': PRIORITY_LOW}

_request_ids = itertools.count()


class SamplingParams:
    """Per-request decode configuration.

    - ``strategy``: 'greedy_search' (raw argmax) or 'sampling'.
    - ``temperature`` / ``top_k`` / ``top_p``: sampling filters, applied
      in that order; ``top_k=0`` and ``top_p=1.0`` disable a filter.
    - ``eos_token_id``: emitting this token finishes the request (the eos
      itself is emitted); ``None`` defers to the engine default, ``-1``
      disables early stop.
    - ``seed``: seed of the request's own `torch.Generator` for
      'sampling' (same seed + same prompt => same tokens, independent of
      batch neighbours).
    """

    __slots__ = ('max_new_tokens', 'strategy', 'temperature', 'top_k',
                 'top_p', 'eos_token_id', 'seed')

    def __init__(self, max_new_tokens: int = 16, strategy: str = GREEDY,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, eos_token_id: Optional[int] = None,
                 seed: Optional[int] = None):
        if strategy not in (GREEDY, SAMPLING):
            raise ValueError(f'unknown strategy {strategy!r}')
        if max_new_tokens < 1:
            raise ValueError('max_new_tokens must be >= 1')
        self.max_new_tokens = int(max_new_tokens)
        self.strategy = strategy
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos_token_id = eos_token_id
        self.seed = seed

    def __repr__(self):
        return (f'SamplingParams(max_new_tokens={self.max_new_tokens}, '
                f'strategy={self.strategy!r}, temperature={self.temperature},'
                f' top_k={self.top_k}, top_p={self.top_p}, '
                f'eos_token_id={self.eos_token_id}, seed={self.seed})')


# request lifecycle states
QUEUED = 'QUEUED'
RUNNING = 'RUNNING'
FINISHED = 'FINISHED'
FAILED = 'FAILED'


class RequestHandle:
    """Live view of one submitted request.

    ``tokens`` grows as the engine decodes; ``status`` moves
    QUEUED -> RUNNING -> FINISHED (or FAILED, carrying ``error`` — a
    request-level failure never kills the engine). Latency marks:
    ``ttft`` (submit -> first token) and ``tpot`` (mean inter-token time
    after the first) are available once the request finishes.

    ``weight_version`` is stamped at admission with the engine's live
    weight version; a weight swap needs a drained engine, so every token
    of the response was decoded under that one version.
    """

    def __init__(self, prompt_tokens: List[int], params: SamplingParams,
                 engine=None):
        self.request_id = next(_request_ids)
        self.prompt_tokens = list(prompt_tokens)
        self.params = params
        self.priority = PRIORITY_NORMAL
        self.tokens: List[int] = []
        self.status = QUEUED
        self.error: Optional[BaseException] = None
        self._engine = engine
        # LoRA adapter this request decodes under (None = base model), the
        # version it pinned at admission, and its bank slot while pinned
        self.adapter_id: Optional[str] = None
        self.adapter_version: Optional[int] = None
        self._adapter_pin: Optional[int] = None
        # the prefix-cache node this request attached pages from (pinned
        # while it runs) and the rows attached
        self._prefix_node = None
        self._prefix_len = 0
        # the weight version this request decodes under (stamped at
        # admission; None while still queued)
        self.weight_version: Optional[int] = None
        self._eos = -1
        self._t_submit = time.perf_counter()
        self._t_first: Optional[float] = None
        self._t_done: Optional[float] = None
        # the open `serving.queue` span (submit to admission), and the
        # request-ledger record (observability.reqledger; None while the
        # ledger is off), owned by the thread driving the engine
        self._queue_span = None
        self._ledger_rec = None

    @property
    def trace_id(self) -> int:
        """The id threaded through this request's spans/events in the
        observability trace view."""
        return self.request_id

    # -- engine-side transitions -------------------------------------------
    def _emit(self, token: int, now: float):
        if self._t_first is None:
            self._t_first = now
            if self._ledger_rec is not None:
                self._ledger_rec.mark_first(now)
        self.tokens.append(int(token))

    def _finish(self, now: Optional[float] = None):
        self.status = FINISHED
        self._t_done = time.perf_counter() if now is None else now
        if self._ledger_rec is not None:
            _reqledger.get_ledger().finalize(self, now=self._t_done,
                                             outcome='completed')

    def _fail(self, exc: BaseException):
        self.status = FAILED
        self.error = exc
        self._t_done = time.perf_counter()
        if self._ledger_rec is not None:
            _reqledger.get_ledger().finalize(self, now=self._t_done,
                                             outcome='failed')

    # -- user-side views ---------------------------------------------------
    @property
    def done(self) -> bool:
        return self.status in (FINISHED, FAILED)

    @property
    def ttft(self) -> Optional[float]:
        """Seconds from submit to the first generated token."""
        if self._t_first is None:
            return None
        return self._t_first - self._t_submit

    @property
    def tpot(self) -> Optional[float]:
        """Mean seconds per output token after the first."""
        if self._t_done is None or self._t_first is None \
                or len(self.tokens) < 2:
            return None
        return (self._t_done - self._t_first) / (len(self.tokens) - 1)

    def stream(self):
        """Per-token iterator: drives the engine until this request is
        done, yielding each generated token as it lands."""
        if self._engine is None:
            raise RuntimeError('handle is not bound to an engine')
        cursor = 0
        while True:
            while cursor < len(self.tokens):
                yield self.tokens[cursor]
                cursor += 1
            if self.done:
                if self.status == FAILED:
                    raise self.error
                return
            self._engine.step()

    def result(self) -> List[int]:
        """Block (drive the engine) until done; returns the token list.
        Raises the request's error if it FAILED."""
        for _ in self.stream():
            pass
        return self.tokens

    def __repr__(self):
        return (f'RequestHandle(id={self.request_id}, status={self.status}, '
                f'prompt_len={len(self.prompt_tokens)}, '
                f'tokens={len(self.tokens)})')
