"""Step watchdog (counterpart of `paddle_tpu/resilience/watchdog.py`):
detect hung steps (a wedged collective or host callback, a dead RPC
peer) that neither raise nor return.

A hang is the failure mode retries and NaN checks cannot see: the step
never comes back. The watchdog is a daemon thread holding a deadline;
each step arms it on entry and disarms it on return. If a step overruns
its deadline the watchdog fires once for that step: /healthz goes 503
(`observability.server.note_hang`) until the step returns, a
`hang_suspected` event carries the last-known span from the EventLog,
`paddle_resilience_hangs_total` counts it, and then the configured abort
action runs: `None` (observe only), `'interrupt'` (KeyboardInterrupt in
the main thread, so the preemption path can checkpoint and exit), or any
callable.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Optional, Union

from .. import flags as _flags
from .. import observability as _obs
from ..analysis.runtime import concurrency as _concurrency


class StepWatchdog:
    """Thread-based deadline monitor for step execution.

    Args:
        deadline_s: seconds a single step may run before it is declared
            hang-suspected (default FLAGS_ft_step_deadline_s; <= 0
            disables the watchdog entirely).
        on_hang: None (event only), 'interrupt' (interrupt_main), or a
            callable(elapsed_seconds).
        poll_interval: check cadence; defaults to deadline / 4 capped to
            [10 ms, 1 s].
    """

    def __init__(self, deadline_s: Optional[float] = None,
                 on_hang: Union[None, str, Callable] = None,
                 poll_interval: Optional[float] = None):
        self.deadline = float(_flags.flag('FLAGS_ft_step_deadline_s')
                              if deadline_s is None else deadline_s)
        self.on_hang = on_hang
        self.poll = poll_interval if poll_interval is not None else \
            min(max(self.deadline / 4.0, 0.01), 1.0)
        self._lock = _concurrency.Lock('StepWatchdog._lock')
        self._armed_at: Optional[float] = None
        self._fired_this_arm = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = 0

    @property
    def enabled(self) -> bool:
        return self.deadline > 0

    def start(self) -> 'StepWatchdog':
        if not self.enabled:
            return self
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name='paddle-step-watchdog', daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def arm(self):
        with self._lock:
            self._armed_at = time.monotonic()
            self._fired_this_arm = False

    def disarm(self):
        with self._lock:
            fired = self._fired_this_arm
            self._armed_at = None
        if fired:
            # the step finally came back: /healthz recovers to 200
            from ..observability.server import clear_hang
            clear_hang(id(self))

    @contextlib.contextmanager
    def watch(self):
        """Bracket one step: arm on entry, disarm on exit (starts the
        monitor thread at first use)."""
        if not self.enabled:
            yield
            return
        self.start()
        self.arm()
        try:
            yield
        finally:
            self.disarm()

    # -- monitor thread -----------------------------------------------------
    def _loop(self):
        while not self._stop.wait(self.poll):
            with self._lock:
                armed_at = self._armed_at
                already = self._fired_this_arm
            if armed_at is None or already:
                continue
            elapsed = time.monotonic() - armed_at
            if elapsed >= self.deadline:
                with self._lock:
                    self._fired_this_arm = True
                self._fire(elapsed)

    def _last_span(self) -> str:
        events = _obs.get_event_log().events()
        return events[-1].get('name', '?') if events else ''

    def _fire(self, elapsed: float):
        self.fired += 1
        # /healthz goes 503 until the hung step returns (disarm); the
        # hang_suspected event below also triggers a flight-recorder dump
        from ..observability.server import note_hang
        note_hang(id(self), {'elapsed_s': round(elapsed, 3),
                             'deadline_s': self.deadline,
                             'last_span': self._last_span()})
        if _obs.enabled():
            _obs.get_registry().counter(
                'paddle_resilience_hangs_total',
                'steps that overran the watchdog deadline').inc()
            _obs.emit('hang_suspected', elapsed_s=round(elapsed, 3),
                      deadline_s=self.deadline, last_span=self._last_span())
        if self.on_hang == 'interrupt':
            import _thread
            _thread.interrupt_main()
        elif callable(self.on_hang):
            self.on_hang(elapsed)


__all__ = ['StepWatchdog']
