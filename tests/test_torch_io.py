"""`io`, `metric` and `hapi.callbacks`, the port against the JAX package,
on the CPU.

io: the same datasets, samplers and loaders from the same seeds give the
same batches in both packages (the port's are CPU torch tensors, the JAX
package's its Tensors; compared as numpy), epoch after epoch, with worker
threads, and from a mid-epoch cursor (`state_dict` / `set_state_dict`),
which `Model.fit(resume=...)` rests on. metric: the same counts and AUC
on seeded predictions, exactly. callbacks: the same hooks change the same
state (early stop, LR plateau, LR scheduler steps), `VisualDL` writes the
JAX callback's records, `ModelCheckpoint` its files.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as jio
import paddle_tpu.metric as jmetric
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.optimizer import lr as tlr


def _arr(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, (tuple, list)):
        return [_arr(v) for v in x]
    if isinstance(x, dict):
        return {k: _arr(v) for k, v in x.items()}
    return np.asarray(x.numpy() if hasattr(x, 'numpy') else x)


def _equal(a, b):
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    else:
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


def _data(n=23, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3).astype(np.float32),
            rng.randint(0, 5, (n,)).astype(np.int64))


def _loaders(**kw):
    x, y = _data()
    return (jio.DataLoader(jio.TensorDataset([x, y]), **kw),
            tio.DataLoader(tio.TensorDataset([x, y]), **kw))


def _epochs(loader, n=3):
    return [[_arr(b) for b in loader] for _ in range(n)]


@pytest.mark.parametrize('kw', [
    dict(batch_size=4),
    dict(batch_size=4, shuffle=True),
    dict(batch_size=5, shuffle=True, drop_last=True),
    dict(batch_size=3, shuffle=True, num_workers=2),
])
def test_loader_batches_equal_jax(kw):
    j, t = _loaders(**kw)
    assert len(j) == len(t)
    for a, b in zip(_epochs(j), _epochs(t)):
        _equal(a, b)
    b = next(iter(t))
    assert isinstance(b[0], torch.Tensor) and b[0].device.type == 'cpu'
    assert b[0].dtype == torch.float32 and b[1].dtype == torch.int64


@pytest.mark.parametrize('num_workers', [0, 2])
def test_mid_epoch_cursor_resumes_like_jax(num_workers):
    j, t = _loaders(batch_size=3, shuffle=True, num_workers=num_workers)
    full = [_arr(b) for b in t]                  # epoch 0
    nxt = [_arr(b) for b in t]                   # epoch 1
    it = iter(t)
    for _ in range(3):
        next(it)
    state = t.state_dict()
    assert state == {'epoch': 2, 'batch_idx': 3}
    for loader in (j, t):
        loader.set_state_dict({'epoch': 1, 'batch_idx': 4})
    rest_j = [_arr(b) for b in j]
    rest_t = [_arr(b) for b in t]
    _equal(rest_j, rest_t)
    _equal(rest_t, nxt[4:])
    assert t.state_dict() == j.state_dict() == {'epoch': 2, 'batch_idx': 0}
    assert len(full) == 8


def test_samplers_give_the_jax_order():
    src = list(range(17))
    for gen in (None, 7):
        for epoch in (0, 1, 5):
            js = jio.RandomSampler(src, generator=gen)
            ts = tio.RandomSampler(src, generator=gen)
            js.set_epoch(epoch)
            ts.set_epoch(epoch)
            assert list(ts) == list(js)
    js = jio.RandomSampler(src, replacement=True, num_samples=30,
                           generator=3)
    ts = tio.RandomSampler(src, replacement=True, num_samples=30,
                           generator=3)
    js.set_epoch(2)
    ts.set_epoch(2)
    assert list(ts) == list(js)
    assert list(tio.SubsetRandomSampler(src[:9], generator=4)) == \
        list(jio.SubsetRandomSampler(src[:9], generator=4))
    np.random.seed(5)
    want = list(jio.WeightedRandomSampler([1, 2, 3, 4], 12))
    np.random.seed(5)
    assert list(tio.WeightedRandomSampler([1, 2, 3, 4], 12)) == want
    jb = jio.BatchSampler(src, batch_size=4, drop_last=True)
    tb = tio.BatchSampler(src, batch_size=4, drop_last=True)
    assert list(tb) == list(jb) and len(tb) == len(jb) == 4


def test_datasets_match_jax():
    x, y = _data(10)
    jd, td = jio.TensorDataset([x, y]), tio.TensorDataset([x, y])
    for split in ([3, 7], [5, 5]):
        js = jio.random_split(jd, split, generator=11)
        ts = tio.random_split(td, split, generator=11)
        assert [s.indices for s in ts] == [s.indices for s in js]
    cat_j = jio.ConcatDataset([jd, jio.Subset(jd, [4, 2])])
    cat_t = tio.ConcatDataset([td, tio.Subset(td, [4, 2])])
    assert len(cat_t) == len(cat_j) == 12
    for i in (0, 9, 10, 11, -1):
        _equal(_arr(list(cat_t[i])), _arr(list(cat_j[i])))
    with pytest.raises(IndexError):
        cat_t[12]
    comp = tio.ComposeDataset([td, tio.TensorDataset([y])])
    assert len(comp[3]) == 3

    class Stream(tio.IterableDataset):
        def __iter__(self):
            return iter(range(7))

    class JStream(jio.IterableDataset):
        def __iter__(self):
            return iter(range(7))
    tl = tio.DataLoader(tio.ChainDataset([Stream(), Stream()]), batch_size=4)
    jl = jio.DataLoader(jio.ChainDataset([JStream(), JStream()]),
                        batch_size=4)
    _equal([_arr(b) for b in tl], [_arr(b) for b in jl])
    with pytest.raises(TypeError):
        len(tl)


def test_collate_keeps_the_jax_dtypes_and_structure():
    batch = [{'a': np.ones(2, np.float32), 'b': 3, 'c': 0.5,
              'd': (torch.zeros(2), 1)} for _ in range(3)]
    got = tio.default_collate_fn(batch)
    assert got['a'].shape == (3, 2) and got['b'].dtype == torch.int64
    assert got['c'].dtype == torch.float32 and got['d'][0].shape == (3, 2)
    want = jio.default_collate_fn([{k: v for k, v in b.items() if k != 'd'}
                                   for b in batch])
    for k in ('a', 'b', 'c'):
        _equal(_arr(got[k]), _arr(want[k]))
    with pytest.raises(TypeError):
        tio.default_collate_fn([object()])
    assert tio.get_worker_info() is None


def test_unported_io_paths_name_roadmap():
    """DistributedBatchSampler waits for distributed/; the native
    collator is ported: it assembles the Python collator's batch."""
    x, _ = _data()
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        tio.DistributedBatchSampler(tio.TensorDataset([x]), 4)
    samples = [[np.full((2, 3), i, np.float32), np.asarray(i, np.int64)]
               for i in range(4)]
    got = tio._NativeCollator(2, 1 << 20).collate(samples, 'tuple')
    want = tio.default_collate_fn(samples)
    assert isinstance(got, tuple) and len(got) == 2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_loader_worker_error_surfaces():
    class Bad(tio.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise ValueError('bad sample')
            return np.float32(i)
    with pytest.raises(ValueError, match='bad sample'):
        list(tio.DataLoader(Bad(), batch_size=2, num_workers=2))


# ---------------------------------------------------------------------------
# metric
# ---------------------------------------------------------------------------

def _preds(n=64, c=5, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, c).astype(np.float32),
            rng.randint(0, c, (n, 1)).astype(np.int64))


@pytest.mark.parametrize('topk', [1, (1, 3)])
def test_accuracy_matches_jax(topk):
    j, t = jmetric.Accuracy(topk=topk), tmetric.Accuracy(topk=topk)
    for seed in range(3):
        pred, lab = _preds(seed=seed)
        jr = j.update(j.compute(paddle.to_tensor(pred),
                                paddle.to_tensor(lab)))
        tr = t.update(t.compute(torch.from_numpy(pred),
                                torch.from_numpy(lab)))
        np.testing.assert_array_equal(np.asarray(tr), np.asarray(jr))
    assert t.accumulate() == j.accumulate()
    assert t.name() == j.name()
    pred, lab = _preds(seed=9)
    assert tmetric.accuracy(torch.from_numpy(pred), torch.from_numpy(lab),
                            k=2) == jmetric.accuracy(pred, lab, k=2)
    t.reset()
    assert t.accumulate() == (0.0 if topk == 1 else [0.0, 0.0])


@pytest.mark.parametrize('cls', ['Precision', 'Recall', 'Auc'])
def test_binary_metrics_match_jax(cls):
    """The port reads bf16 predictions as fp32; the JAX metric gets the
    same values as fp32 arrays."""
    j, t = getattr(jmetric, cls)(), getattr(tmetric, cls)()
    rng = np.random.RandomState(8)
    for _ in range(3):
        p = rng.rand(50).astype(np.float32)
        lab = (rng.rand(50) < p).astype(np.int64)
        if cls == 'Auc':
            p = np.stack([1 - p, p], axis=1)
        pb = torch.from_numpy(p).to(torch.bfloat16)
        j.update(pb.float().numpy(), lab)
        t.update(pb, torch.from_numpy(lab))
    assert t.accumulate() == j.accumulate()
    assert t.name() == j.name()


def test_auc_on_the_same_inputs_equals_jax_exactly():
    j, t = jmetric.Auc(num_thresholds=255), tmetric.Auc(num_thresholds=255)
    rng = np.random.RandomState(2)
    p = rng.rand(200, 2).astype(np.float32)
    lab = rng.randint(0, 2, (200, 1))
    j.update(p, lab)
    t.update(torch.from_numpy(p), torch.from_numpy(lab))
    assert t.accumulate() == j.accumulate() and 0 < t.accumulate() < 1


# ---------------------------------------------------------------------------
# callbacks
# ---------------------------------------------------------------------------

class _Holder:
    """The part of a hapi Model that callbacks read."""

    def __init__(self, opt=None):
        self._optimizer = opt
        self.stop_training = False
        self.saved = []

    def save(self, path):
        self.saved.append(path)


class _Opt:
    def __init__(self, lr):
        self._learning_rate = lr

    def get_lr(self):
        lr = self._learning_rate
        return lr() if callable(lr) else lr

    def set_lr(self, v):
        self._learning_rate = v


def _drive(cb_mod, cls, seq, key='on_eval_end', **kw):
    cb = getattr(cb_mod, cls)(**kw)
    holder = _Holder(_Opt(0.1))
    cb.set_model(holder)
    stops = []
    for v in seq:
        getattr(cb, key)({'loss': v, 'acc': [v]}) if key == 'on_eval_end' \
            else getattr(cb, key)(0, {'loss': v})
        stops.append(holder.stop_training)
    return cb, holder, stops


@pytest.mark.parametrize('cls,kw', [
    ('EarlyStopping', dict(patience=2)),
    ('EarlyStopping', dict(monitor='acc', patience=1, min_delta=0.05)),
    ('ReduceLROnPlateau', dict(patience=2, factor=0.5, verbose=0)),
    ('ReduceLROnPlateau', dict(patience=1, cooldown=2, verbose=0)),
])
def test_plateau_callbacks_match_jax(cls, kw):
    seq = [1.0, 0.9, 0.95, float('nan'), 0.93, 0.91, 0.92, 0.89, 0.9]
    with pytest.warns(UserWarning):
        jc, jh, js = _drive(jcb, cls, seq, **kw)
    with pytest.warns(UserWarning):
        tc, th, ts = _drive(tcb, cls, seq, **kw)
    assert ts == js
    assert th._optimizer.get_lr() == jh._optimizer.get_lr()
    assert (tc.best, tc.wait) == (jc.best, jc.wait)


def test_lr_scheduler_callback_steps_like_jax():
    out = []
    for cb_mod, lr_mod in ((jcb, jlr), (tcb, tlr)):
        sched = lr_mod.StepDecay(0.1, step_size=2, gamma=0.5)
        cb = cb_mod.LRScheduler(by_step=True, by_epoch=True)
        cb.set_model(_Holder(_Opt(sched)))
        lrs = []
        for epoch in range(2):
            for step in range(3):
                cb.on_train_batch_end(step)
                lrs.append(sched())
            cb.on_epoch_end(epoch)
            lrs.append(sched())
        out.append(lrs)
    assert out[0] == out[1]


def test_visualdl_writes_the_jax_records(tmp_path):
    recs = []
    for cb_mod, d in ((jcb, tmp_path / 'j'), (tcb, tmp_path / 't')):
        cb = cb_mod.VisualDL(log_dir=str(d))
        cb.on_train_begin()
        for i, loss in enumerate([2.5, 2.0, 1.75]):
            cb.on_train_batch_end(i, {'loss': loss, 'note': 'x'})
        cb.on_eval_end({'loss': [1.5], 'acc': 0.25})
        cb.on_train_end()
        with open(d / 'metrics.jsonl') as f:
            recs.append([{k: v for k, v in json.loads(line).items()
                          if k != 'time'} for line in f])
    assert recs[1] == recs[0] and len(recs[0]) == 5


def test_model_checkpoint_and_progbar_hooks(tmp_path, capsys):
    saved = []
    for cb_mod in (jcb, tcb):
        holder = _Holder()
        cb = cb_mod.ModelCheckpoint(save_freq=2, save_dir=str(tmp_path))
        cb.set_model(holder)
        for epoch in range(4):
            cb.on_epoch_end(epoch)
        cb.on_train_end()
        saved.append(holder.saved)
        bar = cb_mod.ProgBarLogger(log_freq=2, verbose=2)
        bar.set_params({'epochs': 1})
        bar.on_epoch_begin(0)
        for step in range(3):
            bar.on_train_batch_end(step, {'loss': 1.0 / (step + 1)})
        bar.on_epoch_end(0, {'loss': 0.5})
    err = capsys.readouterr().err.splitlines()
    assert saved[0] == saved[1] == [os.path.join(str(tmp_path), x)
                                    for x in ('0', '2', 'final')]
    half = len(err) // 2
    strip = [line.split(' in ')[0] for line in err]
    assert strip[:half] == strip[half:]


def test_metrics_logger_feeds_telemetry_and_the_spike_detector(tmp_path):
    from paddle_tpu_torch import observability as tobs
    cb = tcb.MetricsLoggerCallback(tokens_per_batch=8,
                                   log_dir=str(tmp_path), export_freq=2)
    cb.on_train_begin()
    for i in range(7):
        cb.on_train_batch_end(i, {'loss': [3.0 if i != 6 else 90.0]})
    cb.on_train_end()
    assert cb._spikes.spikes == [7]
    assert os.path.exists(tmp_path / 'metrics.jsonl')
    assert cb.telemetry is not None and tobs.enabled()
