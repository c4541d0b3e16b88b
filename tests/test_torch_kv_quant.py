"""int8 paged KV (`kv_quant='int8'`) in the port against the JAX package,
on the CPU, and request-level failure handling.

- The three page helpers (`paddle_tpu_torch.quantization`) against the
  JAX ones on random pages, an all-zero page and values exactly at
  +-(k + 0.5) x scale: equal int8 values, scales and dequantized values
  to rel 1e-6.
- The pool programs against the JAX engine's, from the same dirty pages
  and scales: the whole prefill at buckets 8-64 (`_paged_prefill_fn`),
  one chunk step at four starts, a tail-shifted window under a floor
  among them (`_paged_chunk_prefill_fn`), and decode rounds at
  decode_block 1, 4 and 8 (`_paged_decode_fn`) that cross a page
  boundary, run into the slot's last row and carry an inactive slot.
  After each: int8 pages equal but for 1-LSB differences on at most
  0.1% of the elements (the two frameworks' f32 forwards differ by
  about 1e-6, which can move a value across a rounding boundary),
  scales to rel 1e-5, every page the JAX program left unwritten
  unchanged, and the greedy tokens equal.
- The plain paged version with the round's float window against dense
  attention over the JAX `gather_pages(..., scales)` with the window's
  rows written in (f32, 1e-5).
- The port's engine against `JaxEngine(kv_page_size=16,
  kv_quant='int8')`, stepped in lockstep with the pools compared after
  every step (its whole prefills, chunks and decode rounds): a mixed
  wave at decode_block 1 and 4, the prefix cache with chunking, an
  adapter bank; tokens and counters equal, every page free after a
  forced clear.
- A request whose admission or chunk raises fails alone, in both
  engines alike, and leaks no page and no adapter pin; so does one whose
  prefill step raises inside its body.

The tiny GQA Llama's weights are carried from JAX by `from_jax_state`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import quantization as jquant
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.serving import AdapterBank as JaxBank
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu.serving import kv_pool as jpool
from paddle_tpu.serving import make_adapter_factors as jax_factors
from paddle_tpu_torch import quantization as tquant
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.serving import (FAILED, FINISHED, AdapterBank,
                                      InferenceEngine, PagedSlotPool,
                                      SamplingParams, make_adapter_factors)
from paddle_tpu_torch.serving import kv_pool as tpool
from paddle_tpu_torch.serving.prefill_graph import PrefillStep
from paddle_tpu_torch.weights import from_jax_state
from test_torch_observability import isolated_observability

NO_EOS = -1
TARGETS = ('q_proj', 'k_proj', 'v_proj', 'o_proj')
MAX_LEN = 64
PS = 16


@pytest.fixture(autouse=True, scope='module')
def _isolated_observability(tmp_path_factory):
    """A failed request's flight bundle goes to a temp directory, and
    both packages' observability state is reset around this module."""
    yield from isolated_observability(tmp_path_factory)


@pytest.fixture(autouse=True, scope='module')
def _reset_jax_metrics():
    """The JAX engine records into the JAX package's process-global
    metrics registry; zero it after this module."""
    yield
    jax_metrics.get_registry().reset()


@pytest.fixture(scope='module')
def models():
    paddle.seed(11)
    jm = jllama.LlamaForCausalLM(
        jllama.LlamaConfig.tiny(num_key_value_heads=2)).eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = from_jax_state(state, LlamaForCausalLM(
        LlamaConfig.tiny(num_key_value_heads=2), device='cpu'))
    return jm, tm


# ---------------------------------------------------------------------------
# the page helpers
# ---------------------------------------------------------------------------

def _helper_pages():
    rng = np.random.default_rng(0)
    rand = rng.standard_normal((3, PS, 2, 8)).astype(np.float32) * 3
    zero = np.zeros((1, PS, 2, 8), np.float32)
    # absmax 127/8 gives the scale 1/8 exactly; (k + 0.5) / 8 are ties
    ties = ((np.arange(PS * 2 * 8).reshape(1, PS, 2, 8) % 254) - 127
            + 0.5).astype(np.float32) / 8
    ties[0, 0, :, 0] = 127 / 8
    ties[0, 1, :, 0] = -127 / 8
    return np.concatenate([rand, zero, ties])


def test_page_helpers_equal_jax():
    pages = _helper_pages()
    js = np.array(jquant.kv_page_scales(jnp.asarray(pages)))
    ts = tquant.kv_page_scales(torch.from_numpy(pages)).numpy()
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=0)
    assert (ts[3] == 1.0).all() and (ts[4] == 1 / 8).all()
    jq = np.asarray(jquant.kv_quantize_page(jnp.asarray(pages),
                                            jnp.asarray(js)))
    tq = tquant.kv_quantize_page(torch.from_numpy(pages),
                                 torch.from_numpy(js)).numpy()
    assert tq.dtype == np.int8 and np.array_equal(tq, jq)
    # the ties went to the even neighbour, as jnp.round does
    assert np.array_equal(tq[4], np.round(pages[4] * 8).astype(np.int8))
    tie = (pages[4] * 8) % 1 == 0.5
    assert tie.sum() > 200 and (tq[4][tie].astype(np.int32) % 2 == 0).all()
    jd = np.asarray(jquant.kv_dequantize_page(jnp.asarray(jq),
                                              jnp.asarray(js), jnp.float32))
    td = tquant.kv_dequantize_page(torch.from_numpy(tq),
                                   torch.from_numpy(js), torch.float32)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-6, atol=0)
    assert tquant.kv_dequantize_page(
        torch.from_numpy(tq), torch.from_numpy(js),
        torch.bfloat16).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the pool's programs against the JAX engine's
# ---------------------------------------------------------------------------

def _jax_leaves(jpool_):
    """(page leaves, scale leaves, their treedefs) of the JAX pool, in the
    port's order: layer by layer, K then V."""
    pl, ptree = jax.tree_util.tree_flatten(jpool_.pages)
    sl, stree = jax.tree_util.tree_flatten(jpool_.scales)
    return pl, sl, ptree, stree


def _port_leaves(pool):
    return ([t for kv in pool.pages for t in kv],
            [t for kv in pool.scales for t in kv])


def assert_pools_match(jpool_, pool, before=None):
    """int8 pages equal but for 1-LSB differences on at most 0.1% of the
    elements, scales to rel 1e-5 (page 0, the null page both sides write
    junk into, left out); with `before` (the port's leaves before the
    call, which both sides started from), every page the JAX program left
    as it was is unchanged in the port, bit for bit."""
    jp, js, _, _ = _jax_leaves(jpool_)
    tp, ts = _port_leaves(pool)
    for want, got in zip(jp, tp):
        want, got = np.asarray(want)[1:], got.numpy()[1:]
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1, diff.max()
        assert np.count_nonzero(diff) <= 1e-3 * diff.size
    for want, got in zip(js, ts):
        np.testing.assert_allclose(got.numpy()[1:], np.asarray(want)[1:],
                                   rtol=1e-5, atol=0)
    if before is None:
        return
    untouched = None
    for want, old in zip(jp + js, before[0] + before[1]):
        want, old = np.asarray(want), old.numpy()
        same = (want.reshape(len(want), -1)
                == old.reshape(len(old), -1)).all(axis=1)
        untouched = same if untouched is None else untouched & same
    untouched[0] = False
    assert untouched.sum() > 0
    for got, old in zip(tp + ts, before[0] + before[1]):
        assert torch.equal(got[torch.from_numpy(untouched)],
                           old[torch.from_numpy(untouched)])


class _Int8Pair:
    """A JAX engine and a port engine with int8 KV (max_length 64,
    16-row pages), every slot reserved to the same page table in both,
    and both pools' pages and scales filled with the same seeded values
    (pages left dirty by earlier occupants)."""

    def __init__(self, jm, tm, seed, num_slots=2, decode_block=4):
        kw = dict(num_slots=num_slots, max_length=MAX_LEN, kv_page_size=PS,
                  kv_quant='int8', decode_block=decode_block)
        self.jeng = JaxEngine(jm, **kw)
        self.eng = InferenceEngine(tm, **kw)
        for pool in (self.jeng.pool, self.eng.pool):
            for slot in range(num_slots):
                pool.reserve(slot, MAX_LEN)
        assert np.array_equal(self.jeng.pool.page_table,
                              self.eng.pool.page_table)
        self.fill(seed)

    def fill(self, seed):
        rng = np.random.default_rng(seed)
        tp, ts = _port_leaves(self.eng.pool)
        pages = [rng.integers(-127, 128, tuple(t.shape), dtype=np.int8)
                 for t in tp]
        scales = [rng.uniform(0.01, 0.1, tuple(t.shape)).astype(np.float32)
                  for t in ts]
        for t, x in zip(tp + ts, pages + scales):
            t.copy_(torch.from_numpy(x))
        _, _, ptree, stree = _jax_leaves(self.jeng.pool)
        self.jeng.pool.set_device_state(
            jax.tree_util.tree_unflatten(ptree, [jnp.asarray(x)
                                                 for x in pages]),
            jax.tree_util.tree_unflatten(stree, [jnp.asarray(x)
                                                 for x in scales]))

    def snapshot(self):
        tp, ts = _port_leaves(self.eng.pool)
        return [t.clone() for t in tp], [t.clone() for t in ts]

    def table(self, slot):
        return self.eng.pool.page_table[slot:slot + 1]

    def jax_prefill(self, kind, ids, slot, **chunk):
        j = self.jeng
        pages, scales = j.pool.device_state()
        fn = j._chunk_prefill_jit if kind == 'chunk' else j._prefill_jit
        extra = ((jnp.int32(chunk['start']), jnp.int32(chunk['floor']))
                 if kind == 'chunk' else ())
        pages, scales = fn(j._params, j._frozen, j._buffers, pages, scales,
                           jnp.asarray(self.table(slot)),
                           jnp.asarray(ids, jnp.int32), *extra)
        j.pool.set_device_state(pages, scales)

    def port_prefill(self, kind, ids, slot, **staged):
        with torch.inference_mode():
            step = self.eng._prefill_step(kind, ids.shape[1])
            step.stage(ids=ids, table=self.table(slot), **staged)
            step.run_once()

    def decode(self, tok, pos, active):
        """One decode round of both engines; returns (JAX tokens, port
        tokens), each [N, decode_block]."""
        n = len(tok)
        j = self.jeng
        pages, scales = j.pool.device_state()
        toks, pages, scales = j._decode_jit(
            j._params, j._frozen, j._buffers, pages, scales,
            jnp.asarray(j.pool.page_table), tok.astype(np.int32),
            pos.astype(np.int32), np.zeros(n, np.int32), active,
            np.ones(n, np.float32), np.zeros(n, np.int32),
            np.ones(n, np.float32), np.ones(n, bool),
            np.zeros((n, 2), np.uint32))
        j.pool.set_device_state(pages, scales)
        step = self.eng._decode
        with torch.inference_mode():
            step.stage(tok=tok, pos=pos, active=active,
                       table=np.where(active[:, None],
                                      self.eng.pool.page_table, 0),
                       temp=np.ones(n, np.float32),
                       topk=np.zeros(n, np.int64),
                       topp=np.ones(n, np.float32))
            got = step.run(np.zeros(n, bool), [None] * n).numpy().copy()
        return np.asarray(toks), got


def _ids(n, bucket, seed):
    ids = np.zeros((1, bucket), np.int64)
    ids[0, :n] = np.random.RandomState(seed).randint(1, 128, (n,))
    return ids


@pytest.mark.parametrize('bucket,n', [(8, 5), (16, 16), (32, 20), (64, 50)])
def test_whole_prefill_writes_the_jax_int8_pages(models, bucket, n):
    """On dirty pages: each page the bucket touches is quantized from the
    prompt's rows and zeros past the bucket, so the earlier occupant's
    rows reach no scale."""
    jm, tm = models
    pair = _Int8Pair(jm, tm, seed=bucket)
    before = pair.snapshot()
    ids = _ids(n, bucket, seed=n)
    pair.jax_prefill('whole', ids, slot=1)
    pair.port_prefill('whole', ids, slot=1)
    assert_pools_match(pair.jeng.pool, pair.eng.pool, before)
    ps_rows = pair.eng.pool.pages[0][0][
        int(pair.table(1)[0, (bucket - 1) // PS])]
    tail = bucket % PS
    if tail:                        # the bucket's last page: zeros past it
        assert not ps_rows[tail:].any()


# (start, floor): a cold first chunk, a chunk at a start inside a page
# (the page's older rows and the rows past the chunk in its last page
# come from the dequantized row), the chunk after an attached page, a
# tail-shifted window over rows under the floor that ends inside a page
CHUNK_CASES = ((0, 0), (8, 0), (16, 16), (24, 32))


def test_one_chunk_step_writes_the_jax_int8_pages_at_every_start(models):
    """One chunk step of bucket 32 at four starts, each from the same
    dirty pages: the touched pages above the floor are requantized whole
    from the dequantized row, the pages under the floor keep their bytes
    and scales."""
    jm, tm = models
    pair = _Int8Pair(jm, tm, seed=0)
    steps = set()
    for i, (start, floor) in enumerate(CHUNK_CASES):
        pair.fill(seed=0)
        before = pair.snapshot()
        ids = _ids(32, 32, seed=i)
        pair.jax_prefill('chunk', ids, slot=1, start=start, floor=floor)
        pair.port_prefill('chunk', ids, slot=1, start=start, floor=floor)
        steps.add(pair.eng._prefill_steps[('chunk', 32)])
        assert_pools_match(pair.jeng.pool, pair.eng.pool, before)
        tp, ts = _port_leaves(pair.eng.pool)
        for got, old in zip(tp + ts, before[0] + before[1]):
            for pid in pair.table(1)[0, :floor // PS]:
                assert torch.equal(got[pid], old[pid])
    assert len(steps) == 1


# decode_block -> per-slot (position, active): a round inside one page, a
# round that crosses a page boundary, a round that runs into the slot's
# last row (positions clamp at 63: two windows name the last page), and
# an inactive slot (its table row the null page)
DECODE_CASES = {
    1: ((5, True), (15, True), (40, False)),
    4: ((14, True), (61, True), (63, False)),
    8: ((9, True), (58, True), (20, False)),
}


@pytest.mark.parametrize('decode_block', sorted(DECODE_CASES))
def test_decode_round_writes_the_jax_int8_pages(models, decode_block):
    jm, tm = models
    pair = _Int8Pair(jm, tm, seed=decode_block, num_slots=3,
                     decode_block=decode_block)
    case = DECODE_CASES[decode_block]
    pos = np.array([p for p, _ in case], np.int64)
    active = np.array([a for _, a in case], bool)
    tok = np.random.RandomState(decode_block).randint(1, 128, (3,))
    for _ in range(2):                        # two rounds, the second on
        before = pair.snapshot()              # the first one's pages
        want, got = pair.decode(tok, pos, active)
        assert np.array_equal(got[active], want[active])
        assert_pools_match(pair.jeng.pool, pair.eng.pool, before)
        tok = want[:, -1]
        pos = np.minimum(pos + decode_block, MAX_LEN - 1)


def test_last_page_is_written_once_from_the_sub_steps_window(models):
    """A round that runs into the slot's end: the window past the table
    goes to the null page, so the last page holds the rows the sub-steps
    wrote (the JAX scatter writes the same slice there twice)."""
    jm, tm = models
    pair = _Int8Pair(jm, tm, seed=5, num_slots=1, decode_block=8)
    step = pair.eng._decode
    last = int(pair.eng.pool.page_table[0, -1])
    pos = np.array([58], np.int64)
    want, got = pair.decode(np.array([7]), pos, np.array([True]))
    assert np.array_equal(got, want)
    assert int(step.buf['win_first'][0]) == MAX_LEN // PS - 1
    for kv in step._pages:
        for pages, sc, win in ((kv.k, kv.k_scales, kv.k_win),
                               (kv.v, kv.v_scales, kv.v_win)):
            deq = tquant.kv_dequantize_page(pages[last], sc[last],
                                            torch.float32)
            assert torch.allclose(deq[10:], win[0, 0, 10:], rtol=0,
                                  atol=float(sc[last].max()) / 2 + 1e-7)
    assert_pools_match(pair.jeng.pool, pair.eng.pool)


@pytest.mark.parametrize('length', [1, 37, MAX_LEN])
def test_gather_pages_dequantizes_like_jax(length):
    """A slot's rows read through its table row, dequantized into the
    compute dtype (the JAX `gather_pages(..., scales, out_dtype)`)."""
    rng = np.random.default_rng(length)
    kv = [rng.integers(-127, 128, (9, PS, 2, 4), dtype=np.int8)
          for _ in range(2)]
    sc = [rng.uniform(0.01, 0.1, (9, 2)).astype(np.float32)
          for _ in range(2)]
    table = rng.permutation(8)[:MAX_LEN // PS][None].astype(np.int32) + 1
    got = tpool.gather_pages([tuple(torch.from_numpy(x) for x in kv)],
                             torch.from_numpy(table), length,
                             scales=[tuple(torch.from_numpy(x) for x in sc)],
                             dtype=torch.float32)[0]
    want = jpool.gather_pages(tuple(jnp.asarray(x) for x in kv),
                              jnp.asarray(table),
                              tuple(jnp.asarray(x) for x in sc),
                              out_dtype=jnp.float32)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:, :length],
                                   rtol=1e-6, atol=0)


def test_the_int8_pool_matches_the_jax_pool(models):
    jm, tm = models
    jp = jpool.PagedSlotPool(jm, 2, MAX_LEN, page_size=PS, quant='int8')
    tp = PagedSlotPool(tm, 2, MAX_LEN, page_size=PS, quant='int8')
    assert tp.stats()['kv_quant'] == jp.stats()['kv_quant'] == 'int8'
    assert tp.compute_dtype == torch.float32
    assert all(t.dtype == torch.int8 and not t.any()
               for kv in tp.pages for t in kv)
    assert all(t.dtype == torch.float32 and (t == 1).all()
               for kv in tp.scales for t in kv)
    assert tp.pool_bytes == jp.pool_bytes
    assert tp.page_bytes * tp.num_pages == tp.pool_bytes
    for bad in ('fp8', 'int4'):
        with pytest.raises(ValueError):
            jpool.PagedSlotPool(jm, 2, MAX_LEN, page_size=PS, quant=bad)
        with pytest.raises(ValueError):
            PagedSlotPool(tm, 2, MAX_LEN, page_size=PS, quant=bad)
    # copy-on-write carries the page's scales
    s = tp.alloc()
    tp.reserve(s, 32)
    hold = tp.hold_pages(s, 32)
    pid = int(tp.page_table[s, 1])
    for kv, sc in zip(tp.pages, tp.scales):
        kv[0][pid].fill_(3)
        sc[0][pid] = 0.25
    assert tp.ensure_exclusive(s, 20)
    npid = int(tp.page_table[s, 1])
    assert npid != pid
    for kv, sc in zip(tp.pages, tp.scales):
        assert torch.equal(kv[0][npid], kv[0][pid])
        assert (sc[0][npid] == 0.25).all()
    tp.release_hold(hold)
    tp.free(s)
    assert tp.free_page_count == tp.num_pages - 1


# ---------------------------------------------------------------------------
# the plain paged version with the round's float window
# ---------------------------------------------------------------------------

# (length, window's first logical page): lengths 0, 1 and 1024; the
# round's first row at offsets 0, 9 and 15 of its page; a window whose
# second page lies past the table
WINDOW_SLOTS = ((0, 0), (1, 0), (1024, 63), (10, 0), (16, 0), (17, 1),
                (1002, 62), (521, 32))


@pytest.mark.parametrize('hkv', [2, 4])
def test_plain_paged_with_window_is_dense_attention(hkv):
    rng = np.random.default_rng(hkv)
    n, h, d, p, w = len(WINDOW_SLOTS), 8, 16, 64, 2
    num_pages = n * p + 1
    table = (rng.permutation(num_pages - 1)[:n * p] + 1).reshape(n, p)
    kp, vp = (rng.integers(-127, 128, (num_pages, PS, hkv, d),
                           dtype=np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.01, 0.1, (num_pages, hkv)).astype(np.float32)
              for _ in range(2))
    kw, vw = (rng.standard_normal((n, w, PS, hkv, d)).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((n, h, d)).astype(np.float32)
    lengths = np.array([ln for ln, _ in WINDOW_SLOTS], np.int32)
    first = np.array([f for _, f in WINDOW_SLOTS], np.int32)
    # dense: the JAX gather of the dequantized pages, the window's rows in
    k, v = (np.array(x) for x in jpool.gather_pages(
        (jnp.asarray(kp), jnp.asarray(vp)), jnp.asarray(table),
        (jnp.asarray(ks), jnp.asarray(vs))))
    for i, f in enumerate(first):
        rows = min(w * PS, (p - f) * PS)
        k[i, f * PS:f * PS + rows] = kw[i].reshape(-1, hkv, d)[:rows]
        v[i, f * PS:f * PS + rows] = vw[i].reshape(-1, hkv, d)[:rows]
    g = h // hkv
    s = np.einsum('nkgd,nskd->nkgs', q.reshape(n, hkv, g, d) / np.sqrt(d), k)
    live = np.arange(p * PS)[None, :] < lengths[:, None]
    s = np.where(live[:, None, None, :], s, np.finfo(np.float32).min)
    e = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum('nkgs,nskd->nkgd', e / e.sum(-1, keepdims=True),
                     v).reshape(n, h, d)
    t = torch.from_numpy
    got = K.paged_attention(
        t(q), t(kp), t(vp), t(table.astype(np.int32)), t(lengths),
        k_scales=t(ks), v_scales=t(vs), k_win=t(kw), v_win=t(vw),
        win_first=t(first))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # and without the window the window's pages are read as int8 again
    plain = K.paged_attention(t(q), t(kp), t(vp), t(table.astype(np.int32)),
                              t(lengths), k_scales=t(ks), v_scales=t(vs))
    assert not torch.allclose(plain[2:], got[2:])


def test_paged_window_argument_checks():
    q = torch.zeros(1, 2, 16)
    kp = torch.zeros(5, PS, 2, 16, dtype=torch.int8)
    sc = torch.ones(5, 2)
    tbl = torch.zeros(1, 4, dtype=torch.int32)
    ln = torch.ones(1, dtype=torch.int32)
    win = torch.zeros(1, 2, PS, 2, 16)
    first = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        K.paged_attention(q, kp, kp, tbl, ln, k_scales=sc, v_scales=sc,
                          k_win=win, v_win=win)
    with pytest.raises(ValueError):
        K.paged_attention(q, kp.float(), kp.float(), tbl, ln, k_win=win,
                          v_win=win, win_first=first)


# ---------------------------------------------------------------------------
# the engine against the JAX engine, in lockstep
# ---------------------------------------------------------------------------

def _counters(eng):
    st = eng.stats()
    pc, pool = st.get('prefix_cache', {}), st['pool']
    return dict(
        prefills=st['prefills'], prefill_tokens=st['prefill_tokens'],
        chunked_prefills=st['chunked_prefills'],
        chunk_rounds=st['chunk_rounds'], failed=st['failed'],
        completed=st['completed'],
        **{k: pc.get(k) for k in ('hits', 'misses', 'tokens_reused',
                                  'inserts', 'evictions', 'held_pages')},
        **{k: pool[k] for k in ('cow_splits', 'holds_live', 'used_pages',
                                'shared_pages', 'free_pages', 'kv_quant')})


def _lockstep(jeng, eng, waves, new=6, adapter_ids=None, params=None):
    """Each wave submitted to both engines, then both stepped in turn
    until they drain, the pools compared after every step; returns
    (JAX handles, port handles)."""
    jhs, ths = [], []
    for wave in waves:
        ids = adapter_ids or [None] * len(wave)
        kw = params or dict(max_new_tokens=new, eos_token_id=NO_EOS)
        jhs += [jeng.submit(p, JaxParams(**kw), adapter_id=a)
                for p, a in zip(wave, ids)]
        ths += [eng.submit(p, SamplingParams(**kw), adapter_id=a)
                for p, a in zip(wave, ids)]
        while jeng.has_work or eng.has_work:
            jeng.step()
            eng.step()
            assert_pools_match(jeng.pool, eng.pool)
    return jhs, ths


def _engines(jm, tm, jbank=None, bank=None, **kw):
    kw = {'num_slots': 3, 'max_length': 96, 'decode_block': 2,
          'kv_page_size': PS, 'kv_quant': 'int8', **kw}
    return (JaxEngine(jm, adapter_bank=jbank, **kw),
            InferenceEngine(tm, adapter_bank=bank, **kw))


def _rand(n, rng):
    return rng.randint(1, 128, (n,)).tolist()


@pytest.mark.parametrize('decode_block', [1, 4])
def test_engine_tokens_and_pages_match_jax(models, decode_block):
    """A mixed wave of prompts 3-30 on 3 slots (re-admission included)."""
    jm, tm = models
    rng = np.random.RandomState(decode_block)
    wave = [_rand(n, rng) for n in (3, 17, 30, 8, 25, 12)]
    jeng, eng = _engines(jm, tm, decode_block=decode_block, max_length=64)
    jhs, ths = _lockstep(jeng, eng, [wave])
    assert [h.tokens for h in ths] == [h.tokens for h in jhs]
    assert all(h.status == FINISHED for h in ths)
    assert _counters(eng) == _counters(jeng)
    assert eng.stats()['pool']['kv_quant'] == 'int8'
    assert eng.pool.free_page_count == eng.pool.num_pages - 1


def test_prefix_cache_and_chunks_match_jax(models):
    """A shared system prompt behind suffixes, a cold 50-token prompt in
    chunks and a full hit with its COW split: tokens, pages and the hit,
    reuse, chunk-round, COW and page counters equal; every page free
    after a forced clear."""
    jm, tm = models
    rng = np.random.RandomState(0)
    sysp = _rand(20, rng)
    full = _rand(32, rng)
    wave = ([sysp + _rand(n, rng) for n in (3, 12, 5, 30, 9)]
            + [_rand(50, rng), full])
    jeng, eng = _engines(jm, tm, prefix_cache=0.5, prefill_chunk_tokens=16)
    jhs, ths = _lockstep(jeng, eng, [wave[:1] + [full], wave])
    assert [h.tokens for h in ths] == [h.tokens for h in jhs]
    assert _counters(eng) == _counters(jeng)
    st = eng.stats()
    assert st['prefix_cache']['hits'] >= 5 and st['chunk_rounds'] > 0
    assert st['pool']['cow_splits'] == 1
    eng.prefix_cache.clear(force=True)
    assert eng.pool.free_page_count == eng.pool.num_pages - 1
    assert eng.pool.stats()['holds_live'] == 0


def _banks(jm, tm):
    jbank = JaxBank(jm, capacity=3, rank=4, targets=TARGETS)
    bank = AdapterBank(tm, capacity=3, rank=4, targets=TARGETS)
    for i in range(2):
        jbank.load(f'ad{i}', jax_factors(jbank, seed=1 + i, scale=0.2),
                   version=1)
        bank.load(f'ad{i}', make_adapter_factors(bank, seed=1 + i,
                                                 scale=0.2), version=1)
    return jbank, bank


def test_adapter_bank_matches_jax(models):
    jm, tm = models
    rng = np.random.RandomState(4)
    wave = [_rand(n, rng) for n in (5, 20, 9, 28)]
    jeng, eng = _engines(jm, tm, *_banks(jm, tm), prefix_cache=0.5,
                         prefill_chunk_tokens=16)
    ids = [None, 'ad0', 'ad1', 'ad0']
    jhs, ths = _lockstep(jeng, eng, [wave, wave], adapter_ids=ids)
    assert [h.tokens for h in ths] == [h.tokens for h in jhs]
    assert ths[1].tokens != ths[0].tokens
    assert _counters(eng) == _counters(jeng)
    assert eng.adapter_bank.stats()['pinned'] == 0


# ---------------------------------------------------------------------------
# request-level failure
# ---------------------------------------------------------------------------

class Injected(RuntimeError):
    pass


def _inject(eng, fail_begin, fail_chunk):
    """Make `eng` raise at admission for the prompt `fail_begin` and at
    the second chunk of the prompt `fail_chunk` (both engines have
    `_begin_request` and `_prefill_chunk`)."""
    begin, chunk = eng._begin_request, eng._prefill_chunk
    seen = []

    def begin_request(slot, h, *a):
        if h.prompt_tokens == fail_begin:
            raise Injected('admission')
        return begin(slot, h, *a)

    def prefill_chunk(slot, h, *a):
        if h.prompt_tokens == fail_chunk:
            seen.append(1)
            if len(seen) == 2:
                raise Injected('chunk')
        return chunk(slot, h, *a)

    eng._begin_request = begin_request
    eng._prefill_chunk = prefill_chunk


@pytest.mark.parametrize('quant', [None, 'int8'])
def test_a_failing_admission_or_chunk_fails_alone_like_jax(models, quant):
    jm, tm = models
    rng = np.random.RandomState(9)
    sysp = _rand(20, rng)
    wave = ([sysp + _rand(n, rng) for n in (3, 30)] + [_rand(50, rng)]
            + [_rand(n, rng) for n in (7, 40, 11)])
    fail_begin, fail_chunk = wave[3], wave[2]
    jeng, eng = _engines(jm, tm, *_banks(jm, tm), prefix_cache=0.5,
                         prefill_chunk_tokens=16, kv_quant=quant)
    for e in (jeng, eng):
        _inject(e, fail_begin, fail_chunk)
    ids = ['ad0', None, 'ad1', 'ad1', None, 'ad0']
    kw = dict(max_new_tokens=6, eos_token_id=NO_EOS)
    jhs = [jeng.submit(p, JaxParams(**kw), adapter_id=a)
           for p, a in zip(wave, ids)]
    ths = [eng.submit(p, SamplingParams(**kw), adapter_id=a)
           for p, a in zip(wave, ids)]
    while jeng.has_work or eng.has_work:
        jeng.step()
        eng.step()
        if quant:
            assert_pools_match(jeng.pool, eng.pool)
    assert [h.status for h in ths] == [h.status for h in jhs]
    assert [i for i, h in enumerate(ths) if h.status == FAILED] == [2, 3]
    assert isinstance(ths[2].error, Injected)
    assert isinstance(ths[3].error, Injected)
    assert [h.tokens for h in ths if h.status == FINISHED] == \
        [h.tokens for h in jhs if h.status == FINISHED]
    assert eng.stats()['failed'] == jeng.stats()['failed'] == 2
    assert _counters(eng) == _counters(jeng)
    for e in (jeng, eng):
        assert e.adapter_bank.stats()['pinned'] == 0
        e.prefix_cache.clear(force=True)
        assert e.pool.free_page_count == e.pool.num_pages - 1
        assert not e._slot_req and not e._prefilling


def test_a_prefill_step_that_raises_fails_its_request_alone(models):
    """An exception inside `PrefillStep.run_once` (the CPU body): the
    request fails, its slot and pages come back, and the same step
    serves the next request, whose tokens equal a clean engine's."""
    jm, tm = models
    rng = np.random.RandomState(2)
    wave = [_rand(n, rng) for n in (40, 12, 45)]
    kw = dict(num_slots=3, max_length=96, decode_block=2, kv_page_size=PS,
              prefill_chunk_tokens=16, kv_quant='int8')
    eng = InferenceEngine(tm, **kw)
    calls = []
    body = PrefillStep._body

    def faulty(self):
        calls.append(self.kind)
        if len(calls) == 2:
            raise Injected('inside the prefill body')
        return body(self)

    PrefillStep._body = faulty
    try:
        hs = eng.generate_many(wave, SamplingParams(max_new_tokens=5,
                                                    eos_token_id=NO_EOS))
    finally:
        PrefillStep._body = body
    assert [h.status for h in hs].count(FAILED) == 1
    failed = next(i for i, h in enumerate(hs) if h.status == FAILED)
    assert eng.stats()['failed'] == 1
    assert eng.pool.free_page_count == eng.pool.num_pages - 1
    clean = InferenceEngine(tm, **kw).generate_many(
        wave, SamplingParams(max_new_tokens=5, eos_token_id=NO_EOS))
    for i, (h, c) in enumerate(zip(hs, clean)):
        if i != failed:
            assert h.tokens == c.tokens
    # the step that raised serves again
    again = eng.generate_many([wave[failed]], SamplingParams(
        max_new_tokens=5, eos_token_id=NO_EOS))
    assert again[0].tokens == clean[failed].tokens


def test_a_graph_failure_escapes_step(models):
    """A failed capture or replay (`GraphError`) is not one request's
    failure: it escapes `step()`, and nothing is counted as failed."""
    from paddle_tpu_torch.serving.decode_graph import GraphError
    _, tm = models
    eng = InferenceEngine(tm, num_slots=2, max_length=64, kv_page_size=PS,
                          prefill_chunk_tokens=16, kv_quant='int8')

    def broken(*a):
        raise GraphError('replaying the chunk prefill graph failed')

    eng._prefill_chunk = broken
    eng.submit(list(range(1, 30)), max_new_tokens=2, eos_token_id=NO_EOS)
    with pytest.raises(GraphError):
        eng.step()
    assert eng.stats()['failed'] == 0
