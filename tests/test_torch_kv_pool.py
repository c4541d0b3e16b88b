"""The port's paged pool bookkeeping and scheduler against the JAX
package's (`paddle_tpu/serving/kv_pool.py:PagedSlotPool`,
`scheduler.py:FCFSScheduler`), on the CPU: the same sequence of
operations gives the same page tables, free lists, errors and admission
order, and under page sharing (holds, attaches, copy-on-write splits)
the same refcounts; a chunk's floor-redirected writes equal the JAX
`scatter_pages(..., floor=)`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


# ---------------------------------------------------------------------------
# page sharing (tests/test_paged_kv.py:130-230), op for op against JAX
# ---------------------------------------------------------------------------

def _same_refs(j, t):
    _same_state(j, t)
    assert np.array_equal(j._page_refs, t._page_refs)
    for key in ('shared_pages', 'holds_live', 'cow_splits', 'used_pages'):
        assert t.stats()[key] == j.stats()[key], key


def test_cow_split_on_a_shared_page_matches_jax(model):
    j, t = _pools(model)
    holds = []
    for pool in (j, t):
        a = pool.alloc()
        pool.reserve(a, 32)
        hold = pool.hold_pages(a, 32)        # both pages pinned
        pool.free(a)                         # they survive at refs 1
        b = pool.alloc()
        pool.attach_prefix(b, hold, 2)       # shared: refs 2
        assert pool.stats()['shared_pages'] == 2
        assert pool.ensure_exclusive(b, 31)  # row 31 -> page 1 splits
        assert pool.page_table[b][1] != hold.pages[1]
        assert pool.page_table[b][0] == hold.pages[0]
        assert not pool.ensure_exclusive(b, 31)   # exclusive now
        holds.append((b, hold))
    _same_refs(j, t)
    for pool, (b, hold) in zip((j, t), holds):
        pool.free(b)
        pool.release_hold(hold)
    _same_refs(j, t)
    assert t.free_page_count == t.num_pages - 1


def test_cow_copies_every_layers_page(model):
    _, t = _pools(model)
    a = t.alloc()
    t.reserve(a, 16)
    pid = int(t.page_table[a][0])
    gen = torch.Generator().manual_seed(0)
    for k_pages, v_pages in t.pages:
        k_pages[pid] = torch.randn(k_pages[pid].shape, generator=gen)
        v_pages[pid] = torch.randn(v_pages[pid].shape, generator=gen)
    hold = t.hold_pages(a, 16)
    t.free(a)
    b = t.alloc()
    t.attach_prefix(b, hold, 1)
    t.ensure_exclusive(b, 0)
    npid = int(t.page_table[b][0])
    assert npid != pid
    for k_pages, v_pages in t.pages:
        assert torch.equal(k_pages[npid], k_pages[pid])
        assert torch.equal(v_pages[npid], v_pages[pid])


def test_cow_without_a_free_page_raises(model):
    _, t = _pools(model, max_length=32, num_pages=3)   # 2 usable pages
    a = t.alloc()
    t.reserve(a, 32)
    hold = t.hold_pages(a, 32)
    t.free(a)
    b = t.alloc()
    t.attach_prefix(b, hold, 2)
    with pytest.raises(tpool.PagePoolExhausted):
        t.ensure_exclusive(b, 31)
    assert t.stats()['cow_splits'] == 0
    with pytest.raises(RuntimeError):
        t.attach_prefix(b, hold, 1)             # entry already mapped


def test_hold_survives_slot_free_and_releases_clean(model):
    j, t = _pools(model)
    for pool in (j, t):
        slot = pool.alloc()
        pool.reserve(slot, 40)
        hold = pool.hold_pages(slot, 40)        # the 2 full pages only
        assert len(hold.pages) == 2 and hold.kv_len == 32
        pool.free(slot)
        assert pool.used_page_count == 2
        pool.release_hold(hold)
        with pytest.raises(RuntimeError, match='twice'):
            pool.release_hold(hold)
        with pytest.raises(RuntimeError):
            pool.attach_prefix(pool.alloc(), hold, 1)
    _same_refs(j, t)
    assert t.free_page_count == t.num_pages - 1


def test_hold_below_one_page_is_none(model):
    _, t = _pools(model)
    slot = t.alloc()
    t.reserve(slot, 8)
    assert t.hold_pages(slot, 8) is None
    assert t.stats()['holds_live'] == 0


def test_sharing_churn_matches_jax_and_never_leaks(model):
    """Random alloc/reserve/hold/attach/COW/free/release churn on both
    pools: the same tables and refcounts after every step, and every
    page exactly free, mapped or held."""
    j, t = _pools(model, num_slots=6, num_pages=30)
    rng = np.random.RandomState(3)
    holds, seated = [], {}
    for _ in range(300):
        op = rng.randint(5)
        if op == 0 and t.free_count:
            s = j.alloc()
            assert t.alloc() == s
            total = int(rng.randint(1, 65))
            h = holds[rng.randint(len(holds))] if holds and \
                rng.randint(2) else None
            try:
                for pool, hold in zip((j, t), h or (None, None)):
                    if hold is not None:
                        pool.attach_prefix(s, hold, len(hold.pages))
                    pool.reserve(s, max(total, 16 * len(hold.pages)
                                        if hold is not None else total))
                seated[s] = True
            except (jpool.PagePoolExhausted, tpool.PagePoolExhausted):
                j.free(s)
                t.free(s)
        elif op == 1 and seated:
            s = list(seated)[rng.randint(len(seated))]
            rows = t.allocated_rows(s)
            pair = (j.hold_pages(s, rows), t.hold_pages(s, rows))
            if pair[1] is not None:
                holds.append(pair)
        elif op == 2 and seated:
            s = list(seated)[rng.randint(len(seated))]
            del seated[s]
            j.free(s)
            t.free(s)
        elif op == 3 and holds:
            jh, th = holds.pop(rng.randint(len(holds)))
            j.release_hold(jh)
            t.release_hold(th)
        elif op == 4 and seated:
            s = list(seated)[rng.randint(len(seated))]
            pos = int(rng.randint(max(t.allocated_rows(s), 1)))
            try:
                got = (j.ensure_exclusive(s, pos), t.ensure_exclusive(s, pos))
                assert got[0] == got[1]
            except (jpool.PagePoolExhausted, tpool.PagePoolExhausted):
                pass
        _same_refs(j, t)
        refs = t._page_refs[1:]
        assert (refs >= 0).all()
        assert int((refs == 0).sum()) == t.free_page_count
    for jh, th in holds:
        j.release_hold(jh)
        t.release_hold(th)
    for s in seated:
        t.free(s)
    assert t.free_page_count == t.num_pages - 1


@pytest.mark.parametrize('start,length,floor', [(16, 32, 16), (5, 40, 32),
                                                (0, 64, 16), (20, 8, 0),
                                                (40, 24, 48)])
def test_floor_redirect_matches_jax_scatter(model, start, length, floor):
    """A chunk's rows written through the table with a floor equal the JAX
    `scatter_pages(..., floor=)` of the same rows on every page but the
    null page (whose junk differs): pages ending at or below the floor
    keep their bytes."""
    rng = np.random.default_rng(start + floor)
    table = np.array([[3, 7, 1, 5]], np.int32)
    k_pages = rng.standard_normal((9, 16, 2, 16)).astype(np.float32)
    rows = rng.standard_normal((1, length, 2, 16)).astype(np.float32)
    contig = k_pages[table].reshape(1, 64, 2, 16).copy()
    contig[:, start:start + length] = rows
    jp, _ = jpool.scatter_pages(((jnp.asarray(k_pages),),), table,
                                ((jnp.asarray(contig),),),
                                jnp.asarray([start], jnp.int32), length, 16,
                                floor=jnp.asarray([floor], jnp.int32))
    want = np.asarray(jp[0][0])
    tk, tv = torch.from_numpy(k_pages.copy()), torch.zeros(9, 16, 2, 16)
    tpool.scatter_pages([(tk, tv)], torch.from_numpy(table),
                        [(torch.from_numpy(rows), torch.from_numpy(rows))],
                        torch.tensor([start]), floor=torch.tensor([floor]))
    np.testing.assert_array_equal(tk.numpy()[1:], want[1:])
    for i, pid in enumerate(table[0]):
        if (i + 1) * 16 <= floor:
            np.testing.assert_array_equal(tk.numpy()[pid], k_pages[pid])


def test_gather_pages_reads_a_slot_in_table_order(model):
    _, t = _pools(model)
    s = t.alloc()
    t.reserve(s, 40)
    gen = torch.Generator().manual_seed(1)
    for k_pages, v_pages in t.pages:
        k_pages.copy_(torch.randn(k_pages.shape, generator=gen))
        v_pages.copy_(torch.randn(v_pages.shape, generator=gen))
    table = torch.from_numpy(t.page_table[s:s + 1])
    for (k, v), (k_pages, v_pages) in zip(
            tpool.gather_pages(t.pages, table, 37), t.pages):
        want = k_pages[table[0].long()].reshape(1, -1, 2, 16)[:, :37]
        assert k.shape == (1, 37, 2, 16) and torch.equal(k, want)
        assert torch.equal(v[0, 20], v_pages[int(table[0, 1]), 4])
