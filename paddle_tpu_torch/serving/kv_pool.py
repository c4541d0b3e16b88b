"""Paged KV pool (counterpart of `paddle_tpu/serving/kv_pool.py`, the
unquantized `PagedSlotPool` without prefix sharing).

KV storage is one [num_pages, page_size, HKV, D] tensor per layer for K
and one for V, on the model's device. A slot owns a page list (a row of
the [num_slots, pages_per_slot] page table, kept on the host), pages come
from a free list, and page 0 is the reserved null page: unreserved table
entries point at it, so out-of-range writes land in junk that no
attention reads unmasked. Admission reserves every page a request can
touch up front (`reserve`), so a seated request never runs out of pages
mid-decode; exhaustion surfaces at admission as `PagePoolExhausted` and
the engine requeues.

Prefill shapes are length-bucketed: a prompt of length s runs at the
smallest bucket >= s (right-padded; pad KV lands above the live position,
where the decode lengths mask it until the slot's own decode overwrites
it).
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..nlp.generation import update_kv_cache


class PromptTooLongError(ValueError):
    """A prompt is longer than the largest prefill bucket (and therefore
    than max_length)."""


class PagePoolExhausted(RuntimeError):
    """No free KV pages for a reservation: the engine requeues the
    request at the queue front instead of failing it."""


def default_buckets(max_length: int, smallest: int = 8) -> Tuple[int, ...]:
    """Powers of two from `smallest` up to max_length (max_length always
    included so every admissible prompt has a bucket)."""
    out: List[int] = []
    b = smallest
    while b < max_length:
        out.append(b)
        b *= 2
    out.append(max_length)
    return tuple(out)


def _normalize_buckets(buckets, max_length: int) -> Tuple[int, ...]:
    out = tuple(sorted(set(
        int(b) for b in (buckets or default_buckets(max_length))
        if int(b) <= max_length)))
    if not out:
        raise ValueError('no prefill bucket <= max_length')
    return out


def scatter_pages(pages, table: torch.Tensor, slab, start) -> None:
    """Write a contiguous per-layer K/V slab into the pool, in place.

    `pages` is the pool's per-layer [(k_pages, v_pages)], `slab` the
    per-layer [(k, v)] rows [N, L, HKV, D] starting at position start[n]
    of slot row n of `table` [N, P]. Rows on unreserved entries fall on
    the null page."""
    for (k_pages, v_pages), (k, v) in zip(pages, slab):
        update_kv_cache(k_pages, v_pages, k, v, table, start)


class PagedSlotPool:
    """Page-table KV pool: fixed-size pages, per-slot page lists,
    free-list allocation with refcounts, page 0 as the null page.

    Storage is `model.init_cache(num_pages, page_size)`, in the model's
    dtype."""

    def __init__(self, model, num_slots: int, max_length: int,
                 buckets: Optional[Sequence[int]] = None,
                 *, page_size: int = 16, num_pages: Optional[int] = None):
        if num_slots < 1:
            raise ValueError('num_slots must be >= 1')
        if max_length < 2:
            raise ValueError('max_length must be >= 2')
        if page_size < 1:
            raise ValueError('page_size must be >= 1')
        if max_length % page_size != 0:
            raise ValueError(
                f'max_length {max_length} must be a multiple of '
                f'page_size {page_size} (the page table is dense)')
        self.num_slots = int(num_slots)
        self.max_length = int(max_length)
        self.page_size = int(page_size)
        self.pages_per_slot = self.max_length // self.page_size
        # +1: page 0 is the null page
        self.num_pages = int(num_pages) if num_pages is not None else \
            self.num_slots * self.pages_per_slot + 1
        if self.num_pages < self.pages_per_slot + 1:
            raise ValueError(
                f'num_pages {self.num_pages} cannot seat even one '
                f'max-length request ({self.pages_per_slot} pages + '
                f'the null page)')
        self.pages = model.init_cache(self.num_pages, self.page_size)
        self.page_bytes = sum(k.nbytes + v.nbytes
                              for k, v in self.pages) // self.num_pages
        self.pool_bytes = self.page_bytes * self.num_pages
        self.buckets = _normalize_buckets(buckets, self.max_length)
        # host-side address map + refcounts: entry 0 = unreserved/null
        self.page_table = np.zeros(
            (self.num_slots, self.pages_per_slot), np.int32)
        self._page_refs = np.zeros(self.num_pages, np.int64)
        self._page_refs[0] = 1                  # null page: never freed
        self._free_pages: List[int] = list(
            range(self.num_pages - 1, 0, -1))
        self._free = sorted(range(self.num_slots), reverse=True)
        self._written = [0] * self.num_slots

    # -- slot lifecycle ----------------------------------------------------
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_slots - len(self._free)

    @property
    def free_page_count(self) -> int:
        return len(self._free_pages)

    @property
    def used_page_count(self) -> int:
        return self.num_pages - 1 - len(self._free_pages)

    def pages_for(self, length: int) -> int:
        """Pages covering `length` KV rows (ceil division)."""
        return -(-int(length) // self.page_size)

    def alloc(self) -> int:
        """Claim the lowest free slot index; raises when full. Pages are
        reserved separately (`reserve`)."""
        if not self._free:
            raise RuntimeError('slot pool exhausted')
        return self._free.pop()

    def free(self, slot: int):
        """Release the slot and its page references."""
        if not 0 <= slot < self.num_slots:
            raise ValueError(f'slot {slot} out of range')
        if slot in self._free:
            raise ValueError(f'slot {slot} is already free')
        for pid in self.page_table[slot]:
            self._decref(int(pid))
        self.page_table[slot] = 0
        self._free.append(slot)
        self._free.sort(reverse=True)
        self._written[slot] = 0

    def _decref(self, pid: int):
        if pid == 0:
            return
        self._page_refs[pid] -= 1
        if self._page_refs[pid] < 0:
            raise RuntimeError(f'page {pid} freed more than referenced')
        if self._page_refs[pid] == 0:
            self._free_pages.append(pid)

    # -- page lifecycle ----------------------------------------------------
    def reserve(self, slot: int, total_len: int):
        """Ensure `slot`'s table covers [0, total_len): allocate a fresh
        page for every still-null entry in range. All-or-nothing: raises
        PagePoolExhausted (allocating nothing) when the free list cannot
        cover the need."""
        if total_len > self.max_length:
            raise ValueError(
                f'reservation {total_len} exceeds max_length '
                f'{self.max_length}')
        npages = self.pages_for(total_len)
        missing = [i for i in range(npages)
                   if self.page_table[slot, i] == 0]
        if len(missing) > len(self._free_pages):
            raise PagePoolExhausted(
                f'need {len(missing)} KV pages, {len(self._free_pages)} '
                f'free (of {self.num_pages - 1})')
        for i in missing:
            pid = self._free_pages.pop()
            self._page_refs[pid] = 1
            self.page_table[slot, i] = pid

    def note_written(self, slot: int, rows) -> None:
        """High-water mark of the KV rows `slot` holds."""
        r = min(int(rows), self.max_length)
        if r > self._written[slot]:
            self._written[slot] = r

    def allocated_rows(self, slot: int) -> int:
        return int(np.count_nonzero(self.page_table[slot])) * self.page_size

    def bucket_for(self, length: int) -> int:
        """Smallest bucket >= length; `PromptTooLongError` past the
        largest."""
        i = bisect.bisect_left(self.buckets, length)
        if i == len(self.buckets):
            raise PromptTooLongError(
                f'prompt length {length} exceeds the largest prefill '
                f'bucket {self.buckets[-1]} (max_length {self.max_length})')
        return self.buckets[i]

    def stats(self) -> dict:
        used = [s for s in range(self.num_slots) if s not in self._free]
        allocated = sum(self.allocated_rows(s) for s in used)
        written = sum(self._written[s] for s in used)
        return {'num_slots': self.num_slots,
                'max_length': self.max_length,
                'used': self.used_count, 'free': self.free_count,
                'page_size': self.page_size,
                'num_pages': self.num_pages,
                'pages_per_slot': self.pages_per_slot,
                'free_pages': len(self._free_pages),
                'used_pages': self.used_page_count,
                'buckets': list(self.buckets),
                'page_bytes': self.page_bytes,
                'pool_bytes': self.pool_bytes,
                'allocated_rows': allocated,
                'written_rows': written,
                'stranded_rows': allocated - written}
