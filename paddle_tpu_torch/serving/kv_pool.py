"""KV pools (counterpart of `paddle_tpu/serving/kv_pool.py`): the paged
`PagedSlotPool`, unquantized or with `quant='int8'`, and the row
`SlotPool`: the row engine's pool, and a speculating engine's draft KV.

KV storage is one [num_pages, page_size, HKV, D] tensor per layer for K
and one for V, on the model's device. A slot owns a page list (a row of
the [num_slots, pages_per_slot] page table, kept on the host), pages come
from a free list, and page 0 is the reserved null page: unreserved table
entries point at it, so out-of-range writes land in junk that no
attention reads unmasked. Admission reserves every page a request can
touch up front (`reserve`), so a seated request never runs out of pages
mid-decode; exhaustion surfaces at admission as `PagePoolExhausted` and
the engine requeues.

Sharing is per page with refcounts: the prefix cache pins a prompt's
full pages once (`hold_pages` -> `PageHold`) and every request that hits
it maps the same page ids into its table read-only (`attach_prefix`).
The one write into a shared page (a full-prompt hit re-forwarding its
last token) is split off first (`ensure_exclusive`, copy-on-write), and
a chunk's writes carry a `floor` below which they go to the null page,
so a tail-shifted window never rewrites a shared page.

Prefill shapes are length-bucketed: a prompt of length s runs at the
smallest bucket >= s (right-padded; pad KV lands above the live position,
where the decode lengths mask it until the slot's own decode overwrites
it).

With `quant='int8'` the pages are int8 with one f32 scale per (page, kv
head) (`scales`, per layer (k_scales, v_scales) [num_pages, HKV], 1.0 at
start): reads dequantize into `compute_dtype`, the pool's dtype, and
every write requantizes the pages it touches, whole, at their fresh
absmax scale (`nlp.generation.write_pages`); pages it does not touch
are never rewritten, so a settled page does not drift.
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..nlp.generation import gather_rows, update_kv_cache

KV_QUANT_MODES = (None, 'int8')


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


def scatter_pages(pages, table: torch.Tensor, slab, start,
                  floor=None, scales=None) -> None:
    """Write a contiguous per-layer K/V slab into the pool, in place.

    `pages` is the pool's per-layer [(k_pages, v_pages)], `slab` the
    per-layer [(k, v)] rows [N, L, HKV, D] starting at position start[n]
    of slot row n of `table` [N, P]. Rows on unreserved entries fall on
    the null page, and so do rows whose page ends at or below `floor`
    (rows, scalar or [N]; the prefix-attach boundary). With `scales`
    (the int8 pool's per-layer (k_scales, v_scales)) each page the span
    touches is requantized whole from the slab's rows and zeros in the
    rest of the page, as the JAX whole prefill writes it from a zero slab;
    windows outside the span go to the null page."""
    for i, ((k_pages, v_pages), (k, v)) in enumerate(zip(pages, slab)):
        update_kv_cache(k_pages, v_pages, k, v, table, start, floor,
                        None if scales is None else scales[i])


def gather_pages(pages, table_row: torch.Tensor, length: int,
                 scales=None, dtype=None) -> list:
    """The slot's rows [0, length) as contiguous per-layer (k, v)
    [1, length, HKV, D], read through its page table row `table_row`
    [1, P] (counterpart of the JAX `gather_pages`); with `scales` (the
    int8 pool's per-layer (k_scales, v_scales)) dequantized into
    `dtype`."""
    if scales is None:
        scales = [(None, None)] * len(pages)
    return [(gather_rows(k_pages, table_row, length, ks, dtype),
             gather_rows(v_pages, table_row, length, vs, dtype))
            for (k_pages, v_pages), (ks, vs) in zip(pages, scales)]


class SlotPool:
    """Row KV pool (counterpart of the JAX `SlotPool`,
    `paddle_tpu/serving/kv_pool.py:145-326`): one [max_length, HKV, D] row
    per slot and layer, in `dtype` (default the model's: the JAX pool's
    default is float32, a fault of the reference that the port does not
    share, ROADMAP), that belongs to one slot
    for good, and the slot free list. It is the row engine's pool (an
    `InferenceEngine` built without `kv_page_size`, `kv_pages` or
    `kv_quant`), and a speculating engine keeps its draft model's KV in
    one, slot for slot with the target's pool (never allocated or freed
    on its own: slot i of both pools always serves one request).

    The rows are also pages, so every forward reads and writes a row pool
    through the same paged kernels as the paged pool: each layer's
    storage `pages` is [1 + N * P, ps, HKV, D] with P = ceil(max_length /
    ps) (page 0 a null page that no row maps), `cache` its rows [N, P *
    ps, HKV, D] (a view, no copy), and `table` (also `page_table`) the
    fixed identity page table, `table[n, j] = 1 + n * P + j`. Slot n + 1's
    first page follows slot n's last, so a write is kept inside its row:
    positions stop at max_length - 1, and a row past the table, or
    through a zeroed table row, lands on the null page, as in the paged
    pool. Rows past max_length (when ps does not divide it) are never
    written.

    The counters are the JAX pool's: `row_writes` counts the row
    replacements (a whole prefill, a prefill chunk, `set_row`), and
    `row_copies` / `copied_bytes` the whole-row copies of a full prefix
    hit (`copy_slot`); the partial copy a prefix hit's first chunk makes
    (`copy_rows`, the JAX chunk's read of the retained row) is not one.
    """

    scales = None                # rows are never quantized
    quant = None

    def __init__(self, model, num_slots: int, max_length: int,
                 dtype=None, buckets: Optional[Sequence[int]] = None,
                 *, page_size: int = 16):
        if num_slots < 1:
            raise ValueError('num_slots must be >= 1')
        if max_length < 2:
            raise ValueError('max_length must be >= 2')
        if page_size < 1:
            raise ValueError('page_size must be >= 1')
        self.num_slots = int(num_slots)
        self.max_length = int(max_length)
        self.page_size = int(page_size)
        self.pages_per_slot = -(-self.max_length // self.page_size)
        self.pages = model.init_cache(
            1 + self.num_slots * self.pages_per_slot, self.page_size, dtype)
        self.compute_dtype = self.pages[0][0].dtype
        rows = self.pages_per_slot * self.page_size
        self.cache = [tuple(t[1:].view(self.num_slots, rows,
                                       *t.shape[2:]) for t in kv)
                      for kv in self.pages]
        self.table = (1 + np.arange(self.num_slots * self.pages_per_slot,
                                    dtype=np.int32)).reshape(
            self.num_slots, self.pages_per_slot)
        # the JAX row's bytes: [1, max_length, HKV, D] per layer, K and V
        self.row_bytes = sum(t[0, :self.max_length].nbytes
                             for kv in self.cache for t in kv)
        self.pool_bytes = self.row_bytes * self.num_slots
        self.buckets = _normalize_buckets(buckets, self.max_length)
        self._free = sorted(range(self.num_slots), reverse=True)
        # per-slot high-water mark of written rows (the stranded-capacity
        # figure of `_capacity_stats`)
        self._written = [0] * self.num_slots
        # set by the engine, reported in stats() as the JAX pool does
        self.prefill_chunk_tokens: Optional[int] = None
        self._row_writes = 0
        self._row_copies = 0
        self._copied_bytes = 0

    @property
    def page_table(self) -> np.ndarray:
        """The identity page table [N, P] (the paged pool's name for
        it)."""
        return self.table

    # -- slot lifecycle ----------------------------------------------------
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_slots - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.used_count / self.num_slots

    def alloc(self) -> int:
        """Claim the lowest free slot index; raises when full (the
        engine checks what it can free before admitting)."""
        if not self._free:
            raise RuntimeError('slot pool exhausted')
        return self._free.pop()

    def free(self, slot: int):
        if not 0 <= slot < self.num_slots:
            raise ValueError(f'slot {slot} out of range')
        if slot in self._free:
            raise ValueError(f'slot {slot} is already free')
        self._free.append(slot)
        self._free.sort(reverse=True)
        self._written[slot] = 0

    def note_written(self, slot: int, rows) -> None:
        """High-water mark of the KV rows `slot` holds (the engine calls
        it at prefill and after each decode round)."""
        r = min(int(rows), self.max_length)
        if r > self._written[slot]:
            self._written[slot] = r

    def allocated_rows(self, slot: int) -> int:
        """KV rows a seated slot holds: its whole row."""
        return self.max_length

    # -- rows ----------------------------------------------------------------
    def row(self, slot: int) -> list:
        """Slot `slot`'s per-layer (k, v) rows [1, max_length, HKV, D] (a
        view)."""
        return [(k[slot:slot + 1, :self.max_length],
                 v[slot:slot + 1, :self.max_length]) for k, v in self.cache]

    def set_row(self, slot: int, row) -> None:
        """Replace slot `slot`'s row with the per-layer (k, v) [1, S, HKV,
        D], S <= max_length, cast to the pool's dtype; the rows past S
        become zero (a whole-row replace, as the JAX `set_row` stores a
        zero slab's prefill)."""
        table = torch.as_tensor(self.table[slot:slot + 1],
                                device=self.pages[0][0].device)
        scatter_pages(self.pages, table, pad_rows(
            row, self.pages_per_slot * self.page_size), 0)
        self._row_writes += 1

    write_slot = set_row

    def note_row_write(self) -> None:
        """Count a row replacement that a prefill wrote into the slot's
        pages in place (the JAX engine's `set_row` of the prefill's
        row)."""
        self._row_writes += 1

    def copy_slot(self, src: int, dst: int) -> None:
        """Copy row `src` into row `dst` on the device (a full prefix hit:
        the retained row becomes the new request's; the rows above the
        prefix are stale and never read, since a forward reads only the
        rows below its position)."""
        for kv in self.cache:
            for t in kv:
                t[dst].copy_(t[src])
        self._row_copies += 1
        self._copied_bytes += self.row_bytes

    def copy_rows(self, src: int, dst: int, rows: int) -> None:
        """Copy rows [0, rows) of row `src` into row `dst` on the device:
        what a prefix hit's first chunk reads of the retained row, which
        it never writes (not counted as a row copy)."""
        if rows > 0:
            for kv in self.cache:
                for t in kv:
                    t[dst, :rows].copy_(t[src, :rows])

    def reset_rows(self) -> None:
        """Zero every row."""
        for kv in self.pages:
            for t in kv:
                t.zero_()

    def bucket_for(self, length: int) -> int:
        """Smallest bucket >= length; `PromptTooLongError` past the
        largest."""
        i = bisect.bisect_left(self.buckets, length)
        if i == len(self.buckets):
            raise PromptTooLongError(
                f'prompt length {length} exceeds the largest prefill '
                f'bucket {self.buckets[-1]} (max_length {self.max_length})')
        return self.buckets[i]

    def _capacity_stats(self) -> dict:
        """Allocated against written rows over the used slots: a row slot
        holds max_length rows however few it writes, and `stranded_rows`
        is that waste (the JAX `_capacity_stats`)."""
        used = [s for s in range(self.num_slots) if s not in self._free]
        allocated = sum(self.allocated_rows(s) for s in used)
        written = sum(self._written[s] for s in used)
        return {
            'allocated_rows': allocated,
            'written_rows': written,
            'stranded_rows': allocated - written,
            'row_utilization': written / allocated if allocated else 1.0,
            'slot_written_rows': {s: self._written[s] for s in used},
        }

    def stats(self) -> dict:
        return {'num_slots': self.num_slots, 'max_length': self.max_length,
                'used': self.used_count, 'free': self.free_count,
                'buckets': list(self.buckets),
                'prefill_chunk_tokens': self.prefill_chunk_tokens,
                'row_bytes': self.row_bytes,
                'pool_bytes': self.pool_bytes,
                'row_writes': self._row_writes,
                'row_copies': self._row_copies,
                'copied_bytes': self._copied_bytes,
                **self._capacity_stats()}


def pad_rows(slab, length: int) -> list:
    """The per-layer (k, v) rows [B, S, HKV, D] followed by zeros up to
    `length` rows."""
    def pad(x):
        out = x.new_zeros((x.shape[0], length) + tuple(x.shape[2:]))
        out[:, :x.shape[1]] = x
        return out
    return [(pad(k), pad(v)) for k, v in slab]


class PageHold:
    """A reference-counted pin on a set of pages (the prefix cache's
    retained resource): the first `kv_len` rows across `pages` are a
    prompt prefix's prefill KV. Made by `PagedSlotPool.hold_pages`,
    released by `release_hold`; the pages outlive the slot they came
    from for as long as the hold lives."""

    __slots__ = ('pages', 'kv_len', 'released')

    def __init__(self, pages: Tuple[int, ...], kv_len: int):
        self.pages = tuple(int(p) for p in pages)
        self.kv_len = int(kv_len)
        self.released = False

    def __len__(self):
        return len(self.pages)

    def __repr__(self):
        return (f'PageHold(pages={len(self.pages)}, kv_len={self.kv_len}'
                f'{", released" if self.released else ""})')


class PagedSlotPool:
    """Page-table KV pool: fixed-size pages, per-slot page lists,
    free-list allocation, copy-on-write refcounts, page 0 as the null
    page.

    Storage is `model.init_cache(num_pages, page_size, dtype)`, in
    `dtype` (default the model's), or with `quant='int8'` int8 pages of
    the same shape (zeros) and their f32 scales (ones), read and written
    in `dtype` (`compute_dtype`)."""

    def __init__(self, model, num_slots: int, max_length: int,
                 dtype=None, buckets: Optional[Sequence[int]] = None,
                 *, page_size: int = 16, num_pages: Optional[int] = None,
                 quant: Optional[str] = None):
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
        if quant not in KV_QUANT_MODES:
            raise ValueError(f"kv quant mode {quant!r} not supported "
                             f"(None or 'int8')")
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
        self.quant = quant
        if quant == 'int8':
            # the layout of one page, then int8 pages and f32 scales
            one = model.init_cache(1, self.page_size, dtype)
            self.compute_dtype = one[0][0].dtype
            self.pages = [tuple(torch.zeros((self.num_pages,) + t.shape[1:],
                                            dtype=torch.int8,
                                            device=t.device) for t in kv)
                          for kv in one]
            self.scales = [tuple(torch.ones((self.num_pages, t.shape[2]),
                                            dtype=torch.float32,
                                            device=t.device) for t in kv)
                           for kv in one]
        else:
            self.pages = model.init_cache(self.num_pages, self.page_size,
                                          dtype)
            self.compute_dtype = self.pages[0][0].dtype
            self.scales = None
        # a page's bytes: K and V of every layer, and their scales
        self.page_bytes = sum(t.nbytes for kv in self.pages for t in kv)
        if self.scales is not None:
            self.page_bytes += sum(t.nbytes for kv in self.scales
                                   for t in kv)
        self.page_bytes //= self.num_pages
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
        self._cow_splits = 0
        self._holds_live = 0

    # -- slot lifecycle ----------------------------------------------------
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_slots - len(self._free)

    @property
    def occupancy(self) -> float:
        """Occupied-slot fraction, read from the host free list (the
        engine's `paddle_serving_slot_occupancy` per round)."""
        return self.used_count / self.num_slots

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
        """Release the slot and its page references: exclusive pages go
        back to the free list, shared ones (a live `PageHold` or another
        slot's attach) survive at refs >= 1."""
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

    def _incref(self, pid: int):
        if pid != 0:
            self._page_refs[pid] += 1

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

    def attach_prefix(self, slot: int, hold: PageHold, npages: int):
        """Map the first `npages` of a retained hold into `slot`'s table
        read-only (refcounts shared). The engine attaches whole pages
        only and writes strictly above them, except the full-hit
        re-forward of the last prompt token, which `ensure_exclusive`
        splits off first."""
        if hold.released:
            raise RuntimeError('attach_prefix on a released PageHold')
        if npages > len(hold.pages):
            raise ValueError(
                f'attach of {npages} pages exceeds the hold '
                f'({len(hold.pages)})')
        for i in range(npages):
            if self.page_table[slot, i] != 0:
                raise RuntimeError(
                    f'slot {slot} table entry {i} already mapped')
            pid = hold.pages[i]
            self._incref(pid)
            self.page_table[slot, i] = pid

    def ensure_exclusive(self, slot: int, pos: int) -> bool:
        """Copy-on-write split: if the page holding row `pos` of `slot`
        is shared (refs > 1), copy it (K and V of every layer, one page
        each) into a fresh page and repoint the table entry, so writes at
        `pos` never touch the shared original. True when it split;
        `PagePoolExhausted` when no page is free for the copy."""
        i = int(pos) // self.page_size
        pid = int(self.page_table[slot, i])
        if pid == 0:
            raise RuntimeError(
                f'ensure_exclusive on unreserved page {i} of slot {slot}')
        if self._page_refs[pid] <= 1:
            return False
        if not self._free_pages:
            raise PagePoolExhausted(
                'no free page for a copy-on-write split')
        npid = self._free_pages.pop()
        for kv in self.pages + (self.scales or []):
            for t in kv:
                t[npid].copy_(t[pid])
        self._page_refs[npid] = 1
        self.page_table[slot, i] = npid
        self._decref(pid)
        self._cow_splits += 1
        return True

    def hold_pages(self, slot: int, kv_len: int) -> Optional[PageHold]:
        """Pin the full pages covering `slot`'s first `kv_len` rows as a
        `PageHold` (the prefix cache's retention). A trailing partial
        page stays with the slot: on a hit its rows are prefilled again,
        into the new slot's own page. None when no full page is
        covered."""
        npages = int(kv_len) // self.page_size
        if npages < 1:
            return None
        pids = [int(p) for p in self.page_table[slot, :npages]]
        if any(p == 0 for p in pids):
            raise RuntimeError(
                f'hold_pages: slot {slot} has unreserved pages below '
                f'kv_len {kv_len}')
        for pid in pids:
            self._incref(pid)
        self._holds_live += 1
        return PageHold(tuple(pids), npages * self.page_size)

    def release_hold(self, hold: PageHold):
        if hold.released:
            raise RuntimeError('PageHold released twice')
        hold.released = True
        for pid in hold.pages:
            self._decref(pid)
        self._holds_live -= 1

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
                'shared_pages': int(np.sum(self._page_refs[1:] > 1)),
                'holds_live': self._holds_live,
                'cow_splits': self._cow_splits,
                'kv_quant': self.quant,
                'buckets': list(self.buckets),
                'page_bytes': self.page_bytes,
                'pool_bytes': self.pool_bytes,
                'allocated_rows': allocated,
                'written_rows': written,
                'stranded_rows': allocated - written}
