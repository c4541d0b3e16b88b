"""Host C++ libraries of the port, built at first use (the route of
`nlp/fast_tokenizer.py`): a source under `paddle_tpu_torch/csrc/host/`
is compiled with `g++ -O3` into the git-ignored `build/host/` beside the
package, and again when the source is newer than the library, under a
file lock, so concurrent processes build it once. The JAX package's
`csrc/build/` libraries are never loaded.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from pathlib import Path
from typing import Callable, Optional

from ..analysis.runtime import concurrency as _concurrency

SRC_DIR = Path(__file__).resolve().parent.parent / 'csrc' / 'host'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'host'
CXX_FLAGS = ('-O3', '-fPIC', '-shared', '-std=c++17', '-pthread')


class HostLib:
    """One host library: `csrc/host/<source>` built into
    `build/host/lib<name>.so` and bound by `bind(lib)` (ctypes
    signatures). `get()` is the library, built first where needed, or
    None where it cannot be built or loaded (tried once per process)."""

    def __init__(self, name: str, source: str,
                 bind: Callable[[ctypes.CDLL], ctypes.CDLL]):
        self.src = SRC_DIR / source
        self.path = BUILD_DIR / f'lib{name}.so'
        self._bind = bind
        self._lock = _concurrency.Lock(f'host_lib.{name}')
        self._lib = None
        self._tried = False

    def _stale(self) -> bool:
        try:
            return self.src.stat().st_mtime > self.path.stat().st_mtime
        except FileNotFoundError:
            return True

    def _build(self, force: bool = False) -> None:
        """Compile the library unless another process has (a file lock
        over the check and the build; the library replaces the old one
        whole). `force` builds even a library newer than its source (one
        that would not load here)."""
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path.with_suffix('.lock'), 'w') as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not force and not self._stale():
                return
            tmp = self.path.with_suffix(f'.so.tmp{os.getpid()}')
            subprocess.run(['g++', *CXX_FLAGS, str(self.src), '-o',
                            str(tmp)], check=True, capture_output=True)
            os.replace(tmp, self.path)

    def get(self) -> Optional[ctypes.CDLL]:
        with self._lock:
            if self._lib is not None or self._tried:
                return self._lib
            self._tried = True
            try:
                if self._stale():
                    self._build()
                try:
                    lib = ctypes.CDLL(str(self.path))
                except OSError:
                    # built elsewhere (another machine's toolchain)
                    self._build(force=True)
                    lib = ctypes.CDLL(str(self.path))
                self._lib = self._bind(lib)
            except (OSError, subprocess.CalledProcessError):
                # no compiler or no loadable library: available() says so
                self._lib = None
            return self._lib

    def available(self) -> bool:
        return self.get() is not None
