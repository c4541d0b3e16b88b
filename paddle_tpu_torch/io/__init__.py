"""paddle.io: datasets, samplers and the DataLoader (counterpart of
`paddle_tpu/io/__init__.py`; upstream: python/paddle/io/).

The JAX package's semantics, names and order: the same samplers from the
same seeds give the same batches (`RandomSampler`'s numpy `RandomState`
seeded from (generator, epoch) by `set_epoch`), and the DataLoader's
cursor `state_dict()` ({epoch, batch_idx}) resumes mid-epoch on the same
remaining batches, which `hapi.Model.fit(resume=...)` rests on. Worker
threads fetch and collate in parallel and keep the batch order.

Batches are CPU torch tensors (`default_collate_fn`: numpy rows stacked,
ints as int64, floats as float32); `jit.TrainStep` moves them to the
card. As in the JAX loader, a loader with `num_workers > 0` and no
custom `collate_fn` assembles each batch of flat numeric samples in a
staging slot through the host C++ decoder pool (`_NativeCollator` over
`io/native.py`, the port's copy of `csrc/staging.cpp`) where the native
runtime builds, and in Python otherwise; a collator that fails to start
is counted under `count_suppressed('io.native_collator')`. Either way
the batch holds the Python collator's values (a tuple for a tuple or
list sample, as the JAX native collator returns it).
`DistributedBatchSampler` waits for `distributed/` (ROADMAP.md, Queue 1)
and raises.
"""
from __future__ import annotations

import itertools
import math
import threading
from typing import Any, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..analysis.runtime import concurrency as _concurrency
from . import native


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f'{what} is not ported yet (ROADMAP.md, '
                               f'Queue 1)')


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise TypeError('IterableDataset is index-free; iterate it')

    def __len__(self):
        raise TypeError('IterableDataset has no length')


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        arrays = [t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
                  for t in tensors]
        n = arrays[0].shape[0]
        if any(a.shape[0] != n for a in arrays):
            raise ValueError('all tensors must share dim 0')
        self.arrays = arrays

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self.arrays)

    def __len__(self):
        return self.arrays[0].shape[0]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    total = len(dataset)
    if sum(lengths) != total:
        raise ValueError('sum of lengths must equal dataset size')
    rng = np.random.RandomState(generator if isinstance(generator, int)
                                else None)
    perm = rng.permutation(total)
    out, ofs = [], 0
    for ln in lengths:
        out.append(Subset(dataset, perm[ofs:ofs + ln].tolist()))
        ofs += ln
    return out


class ConcatDataset(Dataset):
    """End-to-end concatenation of map-style datasets (upstream
    paddle.io.ConcatDataset)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError('ConcatDataset needs at least one dataset')
        self.cumulative_sizes = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative_sizes.append(total)

    def __getitem__(self, i):
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(f'index {i - n if i < 0 else i} out of '
                             f'range for ConcatDataset of length {n}')
        import bisect
        di = bisect.bisect_right(self.cumulative_sizes, i)
        prev = self.cumulative_sizes[di - 1] if di else 0
        return self.datasets[di][i - prev]

    def __len__(self):
        return self.cumulative_sizes[-1]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        n = len(self.datasets[0])
        if any(len(d) != n for d in self.datasets):
            raise ValueError('datasets must share length')

    def __getitem__(self, i):
        out = []
        for d in self.datasets:
            s = d[i]
            out.extend(s if isinstance(s, (tuple, list)) else [s])
        return tuple(out)

    def __len__(self):
        return len(self.datasets[0])


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        return itertools.chain(*self.datasets)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self.num_samples = num_samples or len(data_source)
        self.generator = generator
        self.epoch: Optional[int] = None  # set_epoch => deterministic order

    def set_epoch(self, epoch: int):
        """Seed this epoch's order from (generator seed, epoch) so the
        sequence is reproducible across interruption/resume (upstream:
        DistributedBatchSampler.set_epoch, extended to plain sampling)."""
        self.epoch = int(epoch)

    def _rng(self):
        base = self.generator if isinstance(self.generator, int) else 0
        if self.epoch is not None:
            return np.random.RandomState(
                (base * 1000003 + self.epoch) % (2 ** 31 - 1))
        return np.random.RandomState(
            self.generator if isinstance(self.generator, int) else None)

    def __iter__(self):
        n = len(self.data_source)
        rng = self._rng()
        if self.replacement:
            return iter(rng.randint(0, n, self.num_samples).tolist())
        return iter(rng.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__(None)
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        if not replacement and num_samples > len(self.weights):
            raise ValueError('cannot draw more than population w/o '
                             'replacement')
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(p), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        super().__init__(dataset)
        if sampler is None:
            sampler = (RandomSampler(dataset) if shuffle
                       else SequenceSampler(dataset))
        self.sampler = sampler
        self.batch_size = int(batch_size)
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last \
            else math.ceil(n / self.batch_size)


class DistributedBatchSampler(BatchSampler):
    """Each data-parallel rank's disjoint shard (the JAX package's
    `DistributedBatchSampler`): waits for `distributed/`."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        raise _not_ported('DistributedBatchSampler (needs distributed/)')


# ---------------------------------------------------------------------------
# collate
# ---------------------------------------------------------------------------

def default_collate_fn(batch: List[Any]):
    """Stack a list of samples into CPU torch tensors, recursing into
    tuples, lists and dicts: arrays and tensors stacked, ints as int64,
    floats as float32 (the JAX collate's dtypes)."""
    first = batch[0]
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate_fn([b[i] for b in batch])
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.stack(batch)
    if isinstance(first, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(first, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, np.int64))
    if isinstance(first, (float, np.floating)):
        return torch.from_numpy(np.asarray(batch, np.float32))
    raise TypeError(f'cannot collate {type(first).__name__}')


def _flat_numeric_samples(sample) -> Optional[List[np.ndarray]]:
    """If a sample is a flat tuple/list of fixed-dtype ndarrays (or
    Python numbers), return them as arrays (the native path); else
    None."""
    items = sample if isinstance(sample, (tuple, list)) else (sample,)
    out = []
    for it in items:
        if isinstance(it, np.ndarray) and it.dtype != object:
            out.append(np.ascontiguousarray(it))
        elif isinstance(it, (int, np.integer)):
            out.append(np.asarray(it, np.int64))
        elif isinstance(it, (float, np.floating)):
            out.append(np.asarray(it, np.float32))
        else:
            return None
    return out


class _NativeCollator:
    """Assemble batches in a staging slot through the C++ decoder pool
    (the JAX package's `_NativeCollator`): each sample's fields are copied
    into the slot by the pool's threads, then each field's rows leave the
    slot as one torch tensor."""

    def __init__(self, n_threads: int, slot_bytes: int, n_slots: int = 4):
        self.pool = native.DecoderPool(max(1, n_threads))
        self.staging = native.StagingBuffer(slot_bytes, n_slots)

    def collate(self, samples: List[List[np.ndarray]], structure):
        nfields = len(samples[0])
        bsz = len(samples)
        # field layout inside the slot, 64-byte aligned
        offsets, sizes, metas = [], [], []
        ofs = 0
        for f in range(nfields):
            per = samples[0][f]
            offsets.append(ofs)
            sizes.append(per.nbytes)
            metas.append(((bsz,) + per.shape, per.dtype))
            ofs += (per.nbytes * bsz + 63) & ~63
        if ofs > self.staging.slot_bytes:
            return None  # batch too large for a slot: the caller collates
        slot = self.staging.acquire()
        if slot < 0:
            return None
        # an exception between acquire() and release() would leak the
        # slot, and after n_slots leaks every worker blocks in acquire
        try:
            ticket = self.pool.ticket()
        except Exception:
            self.staging.release(slot)
            raise
        njobs = 0
        try:
            for f in range(nfields):
                base = self.staging.addr(slot, offsets[f])
                for b, s in enumerate(samples):
                    arr = s[f]
                    self.pool.submit_memcpy(
                        arr.ctypes.data, base + b * sizes[f], arr.nbytes,
                        ticket)
                    njobs += 1
            self.pool.wait(ticket, njobs)
            out = []
            for f in range(nfields):
                shape, dtype = metas[f]
                view = self.staging.view(
                    slot, nbytes=int(np.prod(shape)) * dtype.itemsize,
                    dtype=dtype, shape=shape, offset=offsets[f])
                out.append(torch.from_numpy(np.array(view)))
        finally:
            # the pool's threads hold pointers to the ticket and the slot
            # until every submitted job has run
            self.pool.wait(ticket, njobs)
            self.pool.ticket_free(ticket)
            self.staging.release(slot)
        if structure == 'single':
            return out[0]
        return tuple(out)


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=False, timeout=0, worker_init_fn=None):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self._custom_collate = collate_fn is not None
        self.num_workers = int(num_workers)
        self.prefetch_factor = max(2, int(prefetch_factor))
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
        self._native: Optional[_NativeCollator] = None
        if (self.num_workers > 0 and not self._custom_collate
                and native.available()):
            try:
                self._native = _NativeCollator(
                    self.num_workers, slot_bytes=64 << 20)
            except Exception:
                # Python collation is the supported fallback, but counted:
                # a fleet on the slow path unknowingly is a perf bug
                from ..observability import count_suppressed
                count_suppressed('io.native_collator')
                self._native = None
        # mid-epoch resume cursor: epochs are deterministically seeded
        # via set_epoch, so {epoch, batch_idx} fully determines the
        # remaining sequence
        self._epoch = 0
        self._batch_idx = 0
        self._pending_skip = 0
        self._in_progress = False  # a pass started but never completed
        self._pushed_epoch: Optional[int] = None  # last epoch we seeded
        self._iter_gen = 0  # only the newest iterator drives the cursor

    def __len__(self):
        if self._iterable:
            raise TypeError('DataLoader over IterableDataset has no len')
        return len(self.batch_sampler)

    # -- mid-epoch resume ---------------------------------------------------
    def set_epoch(self, epoch: int):
        """Fix this epoch's shuffle order (forwarded to the sampler).
        Called automatically at the start of each iteration with the
        tracked epoch counter, so shuffle order is reproducible by
        default — the property mid-epoch resume rests on."""
        self._epoch = int(epoch)
        bs = self.batch_sampler
        if bs is None:
            return
        if hasattr(bs, 'set_epoch'):
            bs.set_epoch(self._epoch)
        elif getattr(bs, 'sampler', None) is not None \
                and hasattr(bs.sampler, 'set_epoch'):
            bs.sampler.set_epoch(self._epoch)

    def state_dict(self) -> dict:
        """Cursor {epoch, batch_idx}: how many batches of which epoch
        have been consumed (upstream: fleet dataset/reader state)."""
        return {'epoch': self._epoch, 'batch_idx': self._batch_idx}

    def set_state_dict(self, state: dict):
        """Resume mid-epoch: the next iteration replays epoch `epoch`'s
        deterministic order and skips the first `batch_idx` batches."""
        self._epoch = int(state['epoch'])
        self._batch_idx = int(state['batch_idx'])
        self._pending_skip = self._batch_idx
        self._in_progress = False

    # -- iteration ----------------------------------------------------------
    def _index_batches(self) -> Iterator[List[int]]:
        it = iter(self.batch_sampler)
        for _ in range(self._pending_skip):
            next(it, None)
        self._pending_skip = 0
        yield from it

    def _fetch(self, indices: List[int]):
        return [self.dataset[i] for i in indices]

    def _collate(self, raw: List[Any]):
        if self._native is not None:
            flat = [_flat_numeric_samples(s) for s in raw]
            if all(f is not None for f in flat) and flat:
                shapes0 = [(a.shape, a.dtype) for a in flat[0]]
                if all([(a.shape, a.dtype) for a in f] == shapes0
                       for f in flat):
                    structure = ('single'
                                 if not isinstance(raw[0], (tuple, list))
                                 else 'tuple')
                    out = self._native.collate(flat, structure)
                    if out is not None:
                        return out
        return self.collate_fn(raw)

    def _iter_sync(self):
        if self._iterable:
            skip, self._pending_skip = self._pending_skip, 0
            emitted = 0
            batch = []
            for sample in self.dataset:
                batch.append(sample)
                if len(batch) == self.batch_size:
                    emitted += 1
                    if emitted > skip:
                        yield self._collate(batch)
                    batch = []
            if batch and not self.drop_last:
                emitted += 1
                if emitted > skip:
                    yield self._collate(batch)
            return
        for idx in self._index_batches():
            yield self._collate(self._fetch(idx))

    def _iter_workers(self):
        """Thread team: fetch+decode in parallel, preserve batch order.
        Backpressure: workers stall once `cap` collated batches are
        waiting, so prefetch depth (not dataset size) bounds host memory."""
        cap = self.num_workers * self.prefetch_factor
        n_batches = max(0, len(self.batch_sampler) - self._pending_skip)
        index_it = enumerate(self._index_batches())
        lock = _concurrency.Lock('DataLoader.index_lock')
        stop = threading.Event()
        results: dict = {}
        results_cv = _concurrency.Condition(
            name='DataLoader.results_cv')
        # bound in-flight batches with a semaphore acquired BEFORE taking
        # an index (never block the insert — blocking the worker that
        # holds the batch the consumer is waiting on would deadlock)
        inflight = threading.Semaphore(cap)

        def worker():
            while not stop.is_set():
                inflight.acquire()
                if stop.is_set():
                    return
                with lock:
                    try:
                        seq, idx = next(index_it)
                    except StopIteration:
                        inflight.release()
                        return
                try:
                    batch = self._collate(self._fetch(idx))
                    err = None
                except Exception as e:  # surface in consumer
                    batch, err = None, e
                with results_cv:
                    results[seq] = (batch, err)
                    results_cv.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for want in range(n_batches):
                with results_cv:
                    while want not in results:
                        results_cv.wait(timeout=0.1)
                        if not any(t.is_alive() for t in threads) \
                                and want not in results:
                            raise RuntimeError('DataLoader workers died')
                    batch, err = results.pop(want)
                inflight.release()
                if err is not None:
                    raise err
                yield batch
        finally:
            stop.set()
            for _ in threads:  # unblock workers parked on the semaphore
                inflight.release()

    def _sampler_epoch(self) -> Optional[int]:
        bs = self.batch_sampler
        if bs is None:
            return None
        if getattr(bs, 'epoch', None) is not None:
            return bs.epoch
        return getattr(getattr(bs, 'sampler', None), 'epoch', None)

    def __iter__(self):
        # honor the classic sampler.set_epoch resume idiom: if the user
        # set an epoch on the (batch) sampler directly since we last
        # seeded it, adopt it instead of clobbering with our counter
        ext = self._sampler_epoch()
        if ext is not None and ext != self._pushed_epoch:
            self._epoch = int(ext)
        if self._pending_skip == 0:
            if self._in_progress:
                # a previous pass was abandoned early (break / exception):
                # move on so re-iterating gets a FRESH shuffle order, not
                # a silent replay of the same leading batches
                self._epoch += 1
                self._in_progress = False
            self._batch_idx = 0  # fresh (non-resume) pass restarts cursor
        self.set_epoch(self._epoch)  # pin this epoch's shuffle order
        self._pushed_epoch = self._epoch
        if self.num_workers > 0 and not self._iterable:
            inner = self._iter_workers()
        else:
            inner = self._iter_sync()
        self._iter_gen += 1
        return self._track(inner, self._iter_gen)

    def _track(self, inner, gen):
        """Advance the resume cursor as batches are consumed; roll the
        epoch when an iteration runs to completion. Only the newest
        iterator moves the cursor — a stale concurrent iterator keeps
        yielding but cannot corrupt resume state."""
        for batch in inner:
            if gen == self._iter_gen:
                self._in_progress = True
                self._batch_idx += 1
            yield batch
        if gen == self._iter_gen:
            self._epoch += 1
            self._batch_idx = 0
            self._in_progress = False


def get_worker_info():
    return None  # thread-based workers share the dataset object


__all__ = [
    'ConcatDataset',
    'BatchSampler', 'ChainDataset', 'ComposeDataset', 'DataLoader',
    'Dataset', 'DistributedBatchSampler', 'IterableDataset',
    'RandomSampler', 'Sampler', 'SequenceSampler', 'Subset',
    'SubsetRandomSampler', 'TensorDataset', 'WeightedRandomSampler',
    'default_collate_fn',
    'get_worker_info', 'random_split',
]


class SubsetRandomSampler(Sampler):
    """Sample the given indices in random order (upstream:
    python/paddle/io/sampler.py:SubsetRandomSampler)."""

    def __init__(self, indices, generator=None):
        super().__init__(None)
        self.indices = list(indices)
        self.generator = generator

    def __iter__(self):
        rng = np.random.RandomState(
            self.generator if isinstance(self.generator, int) else None)
        return iter([self.indices[i]
                     for i in rng.permutation(len(self.indices))])

    def __len__(self):
        return len(self.indices)
