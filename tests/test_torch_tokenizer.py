"""The port's tokenizers (paddle_tpu_torch/nlp/tokenizer.py and
fast_tokenizer.py over csrc/host/fast_tokenizer.cpp) against the JAX
package's, on the CPU: the same corpus trains the same vocab and merges,
every sample encodes to the same ids and decodes to the same text, and
`tokenizer.json` files cross both ways. The native merge loop gives the
Python path's ids (its ties and a merge listed twice included), the
library rebuilds when its source is newer, and `ENCODES` counts which
path each encode took. Ids are compared exactly."""
import os
import shutil

import pytest

from paddle_tpu.nlp import fast_tokenizer as jfast
from paddle_tpu.nlp import tokenizer as jtok
from paddle_tpu_torch.nlp import fast_tokenizer as fast
from paddle_tpu_torch.nlp.tokenizer import (BPETokenizer, PretrainedTokenizer,
                                            WhitespaceTokenizer,
                                            _validate_tokenizer_state)
from paddle_tpu_torch.utils.host_lib import HostLib

CORPUS = [
    'the quick brown fox jumps over the lazy dog',
    'pack my box with five dozen liquor jugs',
    'how vexingly quick daft zebras jump',
    'sphinx of black quartz judge my vow',
    'the five boxing wizards jump quickly',
] * 20

SAMPLES = [
    'the quick brown fox',
    'zebras judge quartz vows quickly',
    'completely unseen wordforms zzzqqq',
    'unicode café naïve über 中文 words',
    '  leading and   multiple   spaces  ',
    '',
    'a',
    # unicode whitespace separators (str.split() semantics)
    'quick\xa0brown fox jumps\x0bover',
    # an embedded NUL is a word byte, not a separator
    'quick\x00brown fox',
    'em\u2003space and\u2028line sep',
]


def _trained(cls):
    return cls().train_from_iterator(CORPUS, vocab_size=400)


@pytest.fixture(scope='module')
def bpe_pair():
    return _trained(jtok.BPETokenizer), _trained(BPETokenizer)


def test_bpe_training_and_ids_match_jax(bpe_pair):
    jt, tt = bpe_pair
    assert tt.vocab == jt.vocab and tt.merges == jt.merges
    for s in SAMPLES + CORPUS[:5]:
        assert tt.encode(s) == jt.encode(s), s
        assert tt.tokenize(s) == jt.tokenize(s), s
        assert tt.decode(tt.encode(s)) == jt.decode(jt.encode(s)), s
    batch = ['the lazy dog', 'zebras jump quickly over the box']
    kw = dict(padding=True, add_special_tokens=True, max_length=12)
    assert tt(batch, **kw) == jt(batch, **kw)


def test_whitespace_tokenizer_matches_jax():
    jt = jtok.WhitespaceTokenizer().train_from_iterator(CORPUS, 30)
    tt = WhitespaceTokenizer().train_from_iterator(CORPUS, 30)
    assert tt.vocab == jt.vocab
    for s in SAMPLES:
        assert tt.encode(s, add_special_tokens=True) == \
            jt.encode(s, add_special_tokens=True)
        assert tt.decode(tt.encode(s)) == jt.decode(jt.encode(s))


@pytest.mark.parametrize('direction', ['port_to_jax', 'jax_to_port'])
@pytest.mark.parametrize('kind', ['bpe', 'whitespace', 'fast'])
def test_tokenizer_files_cross_both_ways(tmp_path, direction, kind):
    """A directory saved by either package loads in the other (as the class
    it names) and encodes to the same ids."""
    make = {'bpe': (jtok.BPETokenizer, BPETokenizer),
            'whitespace': (jtok.WhitespaceTokenizer, WhitespaceTokenizer),
            'fast': (jfast.FastBPETokenizer, fast.FastBPETokenizer)}[kind]
    jt = make[0]().train_from_iterator(CORPUS, 300)
    tt = make[1]().train_from_iterator(CORPUS, 300)
    src, dst_cls = ((tt, make[0]) if direction == 'port_to_jax'
                    else (jt, make[1]))
    src.save_pretrained(str(tmp_path))
    loaded = dst_cls.from_pretrained(str(tmp_path))
    assert type(loaded).__name__ == type(src).__name__
    assert loaded.vocab == src.vocab
    for s in SAMPLES:
        assert loaded.encode(s) == src.encode(s), s


@pytest.mark.parametrize('state,match', [
    ([], 'JSON object'),
    ({'vocab': {}}, 'non-empty'),
    ({'vocab': {'a': -1}}, 'invalid id'),
    ({'vocab': {'a': 0, 'b': 0}}, 'duplicate token id 0'),
    ({'vocab': {'a': 0}, 'merges': [['a']]}, 'string pair'),
])
def test_state_validation_matches_jax(state, match):
    for validate in (_validate_tokenizer_state,
                     jtok._validate_tokenizer_state):
        with pytest.raises(ValueError, match=match):
            validate('tokenizer.json', state)


def test_from_pretrained_refuses_a_non_directory(tmp_path):
    with pytest.raises(OSError, match='not a local tokenizer directory'):
        PretrainedTokenizer.from_pretrained(str(tmp_path / 'missing'))


def _fast_of(tok):
    return fast.FastBPETokenizer(vocab=dict(tok.vocab), merges=tok.merges)


def test_fast_bpe_native_path_matches_python_and_jax(bpe_pair):
    jt, tt = bpe_pair
    ft = _fast_of(tt)
    assert fast.available()
    before = dict(fast.ENCODES)
    for s in SAMPLES + CORPUS[:5]:
        assert ft.encode(s) == tt.encode(s) == jt.encode(s), s
        assert ft.tokenize(s) == tt.tokenize(s), s
        assert ft.encode(s, add_special_tokens=True, max_length=4) == \
            jt.encode(s, add_special_tokens=True, max_length=4)
    assert fast.ENCODES['native'] > before['native']
    assert fast.ENCODES['python'] == before['python']


def test_fast_bpe_breaks_ties_as_the_python_loop():
    """Equal-rank pairs merge leftmost first; a merge listed twice keeps
    its last rank (the Python rank dict's), so 'abc' merges a + b first."""
    vocab = {c: i for i, c in enumerate(['a', 'b', 'c', 'aa', 'ab', 'bc',
                                         '</w>'])}
    merges = [('b', 'c'), ('a', 'b'), ('b', 'c'), ('a', 'a')]
    py = BPETokenizer(dict(vocab), merges)
    ft = fast.FastBPETokenizer(dict(vocab), merges)
    for word in ('abc', 'aaaa', 'aaa', 'bcab', 'abcabc'):
        assert ft.tokenize(word) == py.tokenize(word), word
    assert py.tokenize('abc')[:2] == ['ab', 'c']
    # the JAX package's C++ keeps a duplicate merge's first rank, so its
    # fast path parts from its own Python path here (ROADMAP, Queue 3)
    jfast_tok = jfast.FastBPETokenizer(dict(vocab), merges)
    assert jtok.BPETokenizer(dict(vocab), merges).tokenize('abc') == \
        py.tokenize('abc')
    if jfast.available():
        assert jfast_tok.tokenize('abc')[:2] == ['a', 'bc']


def test_fast_bpe_python_path_without_the_library(bpe_pair, monkeypatch):
    """Where no library can be built, encode takes the Python path,
    counted under 'python', with the same ids."""
    _, tt = bpe_pair
    monkeypatch.setattr(fast.LIB, '_lib', None)
    monkeypatch.setattr(fast.LIB, '_tried', True)
    ft = _fast_of(tt)
    assert not fast.available()
    before = dict(fast.ENCODES)
    assert ft.encode(SAMPLES[3]) == tt.encode(SAMPLES[3])
    assert ft.tokenize(SAMPLES[1]) == tt.tokenize(SAMPLES[1])
    assert fast.ENCODES['python'] == before['python'] + 1
    assert fast.ENCODES['native'] == before['native']


def test_fast_library_builds_and_rebuilds_when_the_source_is_newer(
        tmp_path, monkeypatch):
    """The fast tokenizer's build route (`utils/host_lib.py`), on a copy
    of its source and library path under tmp_path."""
    src = tmp_path / 'fast_tokenizer.cpp'
    shutil.copy(fast.SRC, src)
    lib = HostLib('fast_tokenizer', 'fast_tokenizer.cpp', fast._bind)
    monkeypatch.setattr(lib, 'src', src)
    monkeypatch.setattr(lib, 'path', tmp_path / 'build' / 'lib.so')
    assert lib._stale()
    lib._build()
    built = lib.path.stat().st_mtime
    assert not lib._stale()
    lib._build()                       # fresh: left as it is
    assert lib.path.stat().st_mtime == built
    # the source edited after the build: the library is older than it
    os.utime(lib.path, (built - 10, built - 10))
    assert lib._stale()
    lib._build()
    assert not lib._stale() and lib.path.stat().st_mtime > built - 10
    assert (tmp_path / 'build' / 'lib.lock').exists()
    assert not list((tmp_path / 'build').glob('*.tmp*'))
    assert lib.get() is not None and lib.get().bpe_create
