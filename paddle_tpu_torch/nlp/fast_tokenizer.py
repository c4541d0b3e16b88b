"""The BPE tokenizer with its merge loop in host C++ (counterpart of
`paddle_tpu/nlp/fast_tokenizer.py`; upstream analogue: PaddleNLP's
faster_tokenizer).

`FastBPETokenizer` is a `BPETokenizer` whose `encode`/`tokenize` hot
path (whitespace split, the lowest-rank merge loop, vocab lookup with
the byte fallback) runs in `paddle_tpu_torch/csrc/host/fast_tokenizer.cpp`,
the port's own copy of the JAX package's source, bound with ctypes.
The library is built with `g++ -O3` at first use into the git-ignored
`build/host/` beside the package, and again when the source is newer
than it, under a file lock, so concurrent processes build it once
(`utils/host_lib.py`).

Where no compiler or library is at hand, `encode` takes the reference's
Python path. `ENCODES` counts which path each `encode` took
(`'native'` or `'python'`), so a run can show that the native one
served it.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional

from ..utils.host_lib import HostLib
from .tokenizer import BPETokenizer

# the path each encode() took
ENCODES = {'native': 0, 'python': 0}


def _bind(lib):
    lib.bpe_create.restype = ctypes.c_void_p
    lib.bpe_destroy.argtypes = [ctypes.c_void_p]
    lib.bpe_set_unk.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bpe_add_token.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int]
    lib.bpe_add_merge.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_char_p, ctypes.c_int]
    lib.bpe_encode.restype = ctypes.c_int
    lib.bpe_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_int32,
                               ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    return lib


LIB = HostLib('paddle_tpu_torch_fast_tokenizer', 'fast_tokenizer.cpp',
              _bind)
SRC, LIB_PATH = LIB.src, LIB.path


def get_lib():
    """The loaded library, built first where needed; None where it cannot
    be built or loaded (tried once per process): `available()` says so
    and encode() takes the Python path, counted in ENCODES."""
    return LIB.get()


def available() -> bool:
    return LIB.available()


class FastBPETokenizer(BPETokenizer):
    """`BPETokenizer` with the merge loop in C++. The Python data (vocab,
    merges, save and load) is the parent's; only encode's hot path
    moves to native code, which gives the Python path's ids."""

    def __init__(self, vocab=None, merges=None):
        super().__init__(vocab, merges)
        self._native = None
        self._native_dirty = True

    # any change of vocab or merges (training, load) re-syncs the C++ side
    def _load_extra_state(self, state):
        super()._load_extra_state(state)
        # from_pretrained builds through __new__ (no __init__)
        self._native = getattr(self, '_native', None)
        self._native_dirty = True

    def train_from_iterator(self, it, vocab_size=1000, min_frequency=2):
        out = super().train_from_iterator(it, vocab_size, min_frequency)
        self._native_dirty = True
        return out

    def _sync_native(self):
        lib = get_lib()
        if lib is None:
            return None
        if self._native is not None and not self._native_dirty:
            return self._native
        if self._native is not None:
            lib.bpe_destroy(self._native)
        h = lib.bpe_create()
        lib.bpe_set_unk(h, self.unk_token_id)
        for tok, i in self.vocab.items():
            lib.bpe_add_token(h, tok.encode('utf-8'), i)
        for rank, (a, b) in enumerate(self.merges):
            lib.bpe_add_merge(h, a.encode('utf-8'), b.encode('utf-8'), rank)
        self._native = h
        self._native_dirty = False
        return h

    def encode(self, text: str, add_special_tokens: bool = False,
               max_length: Optional[int] = None) -> List[int]:
        h = self._sync_native()
        if h is None:
            ENCODES['python'] += 1
            return super().encode(text, add_special_tokens, max_length)
        ENCODES['native'] += 1
        # ' '.join(text.split()) keeps Python's str.split() semantics
        # (unicode whitespace separators), so the C side sees ASCII-space-
        # separated words; NUL bytes stay word bytes through the explicit
        # length
        data = ' '.join(text.split()).encode('utf-8')
        cap = max(256, len(data) * 2)
        buf = (ctypes.c_int32 * cap)()
        lib = get_lib()
        n = lib.bpe_encode(h, data, len(data), buf, cap)
        if n > cap:      # a byte-fallback blowup: again with room for all
            buf = (ctypes.c_int32 * n)()
            n = lib.bpe_encode(h, data, len(data), buf, n)
        ids = list(buf[:n])
        if add_special_tokens:
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
        if max_length is not None:
            ids = ids[:max_length]
        return ids

    def tokenize(self, text: str) -> List[str]:
        if self._sync_native() is None:
            return super().tokenize(text)
        return self.convert_ids_to_tokens(self.encode(text))

    def __del__(self):
        if getattr(self, '_native', None) is not None and \
                LIB._lib is not None:
            LIB._lib.bpe_destroy(self._native)
            self._native = None


__all__ = ['ENCODES', 'FastBPETokenizer', 'available', 'get_lib']
