"""Preemption handling: SIGTERM/SIGINT -> a "drain and exit cleanly" flag
(counterpart of `paddle_tpu/resilience/preemption.py`). A caught signal
emits `preemption_signal`.

Spot and preemptible fleets deliver eviction as a signal with a grace
window. The handler only *flags*; the serving engine polls `requested`
at the top of `submit` and `step` (`InferenceEngine.
enable_graceful_drain`), stops admitting, and finishes what it has
accepted. A second SIGINT while the flag is set escalates to the normal
KeyboardInterrupt so a stuck process can still be killed from the
keyboard.
"""
from __future__ import annotations

import signal
import threading
from typing import Callable, Optional, Sequence

from .. import observability as _obs


class PreemptionHandler:
    """Install/remove signal handlers that set a 'preempted' flag.

    Usable as a context manager. Install is a no-op off the main thread
    (CPython restricts signal.signal to the main thread) — `requested`
    can still be set manually via `request()` there.
    """

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,
                                                 signal.SIGINT),
                 callback: Optional[Callable[[int], None]] = None):
        self.signals = tuple(signals)
        self.callback = callback
        self._requested = False
        self._signum: Optional[int] = None
        self._prev = {}
        self._installed = False

    @property
    def requested(self) -> bool:
        return self._requested

    @property
    def signum(self) -> Optional[int]:
        return self._signum

    def request(self, signum: int = signal.SIGTERM):
        """Flag a preemption manually (tests, cluster-manager hooks that
        deliver eviction out-of-band)."""
        self._handle(signum, None)

    def _handle(self, signum, frame):
        if self._requested and signum == signal.SIGINT:
            # second ctrl-C: the operator means it — die the normal way
            raise KeyboardInterrupt
        self._requested = True
        self._signum = signum
        _obs.emit('preemption_signal', signum=int(signum))
        if self.callback is not None:
            self.callback(signum)

    def install(self) -> 'PreemptionHandler':
        if self._installed \
                or threading.current_thread() is not threading.main_thread():
            return self
        for s in self.signals:
            try:
                self._prev[s] = signal.signal(s, self._handle)
            except (ValueError, OSError):  # exotic embedding contexts
                pass
        self._installed = True
        return self

    def uninstall(self):
        if not self._installed:
            return
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()
        self._installed = False

    def reset(self):
        """Clear the flag (after the forced checkpoint was taken)."""
        self._requested = False
        self._signum = None

    def __enter__(self) -> 'PreemptionHandler':
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
