"""ctypes bindings for the C++ staging runtime (counterpart of
`paddle_tpu/io/native.py`), over the port's own copy of its source,
`paddle_tpu_torch/csrc/host/staging.cpp`.

The library is built with g++ at first use into the git-ignored
`build/host/` (`utils/host_lib.py`) and again when the source is newer;
`available()` is False where no compiler is present, and the DataLoader
then collates in Python. Two pieces: `StagingBuffer`, a ring of
fixed-size, 64-byte-aligned host slots, and `DecoderPool`, a team of C++
threads that runs copy and u8->f32 jobs without the GIL (`JOB_*`). The
pool's destructor joins its threads.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..utils.host_lib import HostLib

JOB_MEMCPY = 0
JOB_U8_TO_F32 = 1
JOB_F32_SCALE = 2


def _bind(lib):
    lib.staging_create.restype = ctypes.c_void_p
    lib.staging_create.argtypes = [ctypes.c_size_t, ctypes.c_int]
    lib.staging_acquire.restype = ctypes.c_int
    lib.staging_acquire.argtypes = [ctypes.c_void_p]
    lib.staging_ptr.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.staging_ptr.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.staging_slot_bytes.restype = ctypes.c_size_t
    lib.staging_slot_bytes.argtypes = [ctypes.c_void_p]
    lib.staging_commit.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_size_t]
    lib.staging_pop.restype = ctypes.c_int
    lib.staging_pop.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_size_t)]
    lib.staging_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.staging_close.argtypes = [ctypes.c_void_p]
    lib.staging_destroy.argtypes = [ctypes.c_void_p]
    lib.pool_create.restype = ctypes.c_void_p
    lib.pool_create.argtypes = [ctypes.c_int]
    lib.pool_submit.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_size_t, ctypes.c_float,
                                ctypes.c_float, ctypes.c_void_p]
    lib.pool_ticket_create.restype = ctypes.c_void_p
    lib.pool_ticket_count.restype = ctypes.c_int
    lib.pool_ticket_count.argtypes = [ctypes.c_void_p]
    lib.pool_ticket_wait.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.pool_ticket_destroy.argtypes = [ctypes.c_void_p]
    lib.pool_destroy.argtypes = [ctypes.c_void_p]
    return lib


LIB = HostLib('paddle_tpu_torch_staging', 'staging.cpp', _bind)


def get_lib():
    return LIB.get()


def available() -> bool:
    return LIB.available()


def _require():
    lib = get_lib()
    if lib is None:
        raise RuntimeError('native staging runtime unavailable')
    return lib


class StagingBuffer:
    """Ring of fixed-size aligned host slots (the consumer side returns
    numpy views onto slot memory)."""

    def __init__(self, slot_bytes: int, n_slots: int = 4):
        self._lib = _require()
        self._h = self._lib.staging_create(slot_bytes, n_slots)
        if not self._h:
            raise MemoryError('staging_create failed')
        self.slot_bytes = slot_bytes

    def acquire(self) -> int:
        return self._lib.staging_acquire(self._h)

    def view(self, slot: int, nbytes=None, dtype=np.uint8, shape=None,
             offset=0):
        ptr = self._lib.staging_ptr(self._h, slot)
        n = nbytes if nbytes is not None else self.slot_bytes - offset
        buf = (ctypes.c_uint8 * n).from_address(
            ctypes.addressof(ptr.contents) + offset)
        arr = np.frombuffer(buf, dtype=dtype)
        return arr.reshape(shape) if shape is not None else arr

    def addr(self, slot: int, offset: int = 0) -> int:
        ptr = self._lib.staging_ptr(self._h, slot)
        return ctypes.addressof(ptr.contents) + offset

    def commit(self, slot: int, nbytes: int):
        self._lib.staging_commit(self._h, slot, nbytes)

    def pop(self):
        n = ctypes.c_size_t(0)
        idx = self._lib.staging_pop(self._h, ctypes.byref(n))
        return idx, n.value

    def release(self, slot: int):
        self._lib.staging_release(self._h, slot)

    def close(self):
        if self._h:
            self._lib.staging_close(self._h)

    def __del__(self):
        if getattr(self, '_h', None):
            self._lib.staging_destroy(self._h)
            self._h = None


class DecoderPool:
    """C++ worker team for GIL-free sample copy and decode jobs; its
    threads are joined when it is dropped."""

    def __init__(self, n_threads: int):
        self._lib = _require()
        self._h = self._lib.pool_create(n_threads)

    def ticket(self):
        return self._lib.pool_ticket_create()

    def submit_memcpy(self, src_addr: int, dst_addr: int, nbytes: int,
                      ticket):
        self._lib.pool_submit(self._h, JOB_MEMCPY, src_addr, dst_addr,
                              nbytes, 1.0, 0.0, ticket)

    def submit_u8_to_f32(self, src_addr: int, dst_addr: int, n: int,
                         scale: float, shift: float, ticket):
        self._lib.pool_submit(self._h, JOB_U8_TO_F32, src_addr, dst_addr,
                              n, scale, shift, ticket)

    def wait(self, ticket, count: int):
        self._lib.pool_ticket_wait(ticket, count)

    def ticket_done(self, ticket) -> int:
        return self._lib.pool_ticket_count(ticket)

    def ticket_free(self, ticket):
        self._lib.pool_ticket_destroy(ticket)

    def close(self):
        """Join the worker threads now (idempotent)."""
        if getattr(self, '_h', None):
            self._lib.pool_destroy(self._h)
            self._h = None

    __del__ = close
