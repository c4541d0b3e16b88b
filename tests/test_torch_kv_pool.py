"""The port's paged pool bookkeeping and scheduler against the JAX
package's (`paddle_tpu/serving/kv_pool.py:PagedSlotPool`,
`scheduler.py:FCFSScheduler`), on the CPU: the same sequence of
operations gives the same page tables, free lists, errors and admission
order."""
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.serving import api as japi
from paddle_tpu.serving import kv_pool as jpool
from paddle_tpu.serving.scheduler import FCFSScheduler as JaxScheduler
from paddle_tpu_torch import dtype as tdtype
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import api as tapi
from paddle_tpu_torch.serving import kv_pool as tpool
from paddle_tpu_torch.serving.scheduler import FCFSScheduler


class _JaxKV:
    """The JAX pool's init_cache contract: one layer of [B, L, H, D]."""

    def init_cache(self, batch, length, dtype=None):
        shape = (batch, length, 2, 4)
        return ((jnp.zeros(shape), jnp.zeros(shape)),)


@pytest.fixture(scope='module')
def model():
    return LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                            device='cpu')


def _pools(model, num_slots=4, max_length=64, num_pages=None):
    return (jpool.PagedSlotPool(_JaxKV(), num_slots, max_length,
                                page_size=16, num_pages=num_pages),
            tpool.PagedSlotPool(model, num_slots, max_length, page_size=16,
                                num_pages=num_pages))


def _same_state(j, t):
    assert np.array_equal(j.page_table, t.page_table)
    assert j.free_page_count == t.free_page_count
    assert j.free_count == t.free_count
    assert j._free_pages == t._free_pages


def test_reserve_free_churn_matches_jax(model):
    j, t = _pools(model, num_pages=12)
    rng = np.random.default_rng(0)
    seated = []
    for step in range(60):
        if seated and (rng.random() < 0.4 or j.free_count == 0):
            slot = seated.pop(int(rng.integers(len(seated))))
            j.free(slot)
            t.free(slot)
        else:
            sj, st = j.alloc(), t.alloc()
            assert sj == st
            total = int(rng.integers(1, 65))
            outcomes = []
            for pool in (j, t):
                try:
                    pool.reserve(sj, total)
                    outcomes.append('ok')
                except (jpool.PagePoolExhausted,
                        tpool.PagePoolExhausted):
                    pool.free(sj)
                    outcomes.append('exhausted')
            assert outcomes[0] == outcomes[1]
            if outcomes[0] == 'ok':
                seated.append(sj)
        _same_state(j, t)
    for slot in seated:
        t.free(slot)
    assert t.free_page_count == t.num_pages - 1 and t.used_page_count == 0


def test_exhaustion_is_all_or_nothing(model):
    _, t = _pools(model, max_length=32, num_pages=4)   # 3 usable pages
    s = t.alloc()
    t.reserve(s, 32)                              # 2 pages
    s2 = t.alloc()
    with pytest.raises(tpool.PagePoolExhausted):
        t.reserve(s2, 20)                         # needs 2, 1 free
    assert not t.page_table[s2].any() and t.free_page_count == 1
    assert 0 not in t.page_table[s]               # null page never handed out


def test_validation_matches_jax(model):
    for kw in (dict(num_slots=0), dict(max_length=40),
               dict(num_pages=3)):
        args = dict(num_slots=2, max_length=64)
        args.update(kw)
        with pytest.raises(ValueError):
            jpool.PagedSlotPool(_JaxKV(), args['num_slots'],
                                args['max_length'], page_size=16,
                                num_pages=args.get('num_pages'))
        with pytest.raises(ValueError):
            tpool.PagedSlotPool(model, args['num_slots'], args['max_length'],
                                page_size=16,
                                num_pages=args.get('num_pages'))
    _, t = _pools(model)
    with pytest.raises(ValueError):
        t.reserve(t.alloc(), 65)
    with pytest.raises(ValueError):
        t.free(3)                                  # already free


@pytest.mark.parametrize('max_length,buckets', [(64, None), (1024, None),
                                                (64, (5, 17, 64, 100))])
def test_buckets_match_jax(model, max_length, buckets):
    j = jpool.PagedSlotPool(_JaxKV(), 2, max_length, buckets=buckets,
                            page_size=16)
    t = tpool.PagedSlotPool(model, 2, max_length, buckets=buckets,
                            page_size=16)
    assert t.buckets == j.buckets
    assert tpool.default_buckets(max_length) == \
        jpool.default_buckets(max_length)
    for n in (1, 5, 8, 9, 17, max_length):
        assert t.bucket_for(n) == j.bucket_for(n)
    with pytest.raises(tpool.PromptTooLongError):
        t.bucket_for(max_length + 1)


def test_pool_storage_is_the_models_pages(model):
    _, t = _pools(model)
    k, v = t.pages[0]
    assert k.shape == (t.num_pages, 16, 2, 16) and k.dtype == model.dtype
    assert t.pool_bytes == 2 * k.nbytes * len(t.pages)


@pytest.mark.parametrize('budget', [None, 32, 100])
def test_scheduler_admission_order_matches_jax(budget):
    rng = np.random.default_rng(budget or 1)
    lens = rng.integers(1, 60, 9).tolist()
    prios = rng.integers(0, 3, 9).tolist()
    js, ts = JaxScheduler(budget), FCFSScheduler(budget)
    jh, th = [], []
    for n, pr in zip(lens, prios):
        a = japi.RequestHandle([1] * n, japi.SamplingParams())
        b = tapi.RequestHandle([1] * n, tapi.SamplingParams())
        a.priority = b.priority = pr
        js.submit(a)
        ts.submit(b)
        jh.append(a)
        th.append(b)
    bucket = lambda n: 1 << (n - 1).bit_length()
    while js.queue_depth:
        got_j = [jh.index(h) for h in js.admissible(3, bucket)]
        got_t = [th.index(h) for h in ts.admissible(3, bucket)]
        assert got_t == got_j
        if got_j:                      # the last of each batch bounces back
            js.requeue(jh[got_j[-1]])
            ts.requeue(th[got_t[-1]])
            js.admissible(1, bucket)
            ts.admissible(1, bucket)
    assert ts.queue_depth == 0


def test_dtype_names():
    assert tdtype.to_torch_dtype('bfloat16') is tdtype.bfloat16
    assert tdtype.to_torch_dtype(tdtype.float32) is tdtype.float32
    with pytest.raises(ValueError):
        tdtype.to_torch_dtype('float8')
