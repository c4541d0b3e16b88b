"""Offline tokenizers (counterpart of `paddle_tpu/nlp/tokenizer.py`; the
upstream analogue is PaddleNLP's `paddlenlp/transformers/*/tokenizer.py`).

Two offline implementations over one API:
- `WhitespaceTokenizer`: a vocab over whitespace-split tokens;
- `BPETokenizer`: character BPE with trainable merges
  (`train_from_iterator`), the lowest-rank merge applied first, and a
  `<0xNN>` byte fallback, so that any string round-trips.

The vocab and merges persist as `tokenizer.json` in a local directory
(`save_pretrained` / `from_pretrained`), the JSON the JAX package
writes: a tokenizer saved by either package loads in the other. There
is no hub download. The file is checked (`_validate_tokenizer_state`)
before it is used. No torch here: the ids go to a model as the caller
makes them tensors.
"""
from __future__ import annotations

import collections
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def _validate_tokenizer_state(fname: str, state) -> Dict:
    """Schema check for a saved tokenizer.json; raises ValueError naming
    the file and the first offending entry."""
    if not isinstance(state, dict):
        raise ValueError(
            f'{fname}: expected a JSON object, got {type(state).__name__}')
    vocab = state.get('vocab')
    if not isinstance(vocab, dict) or not vocab:
        raise ValueError(f"{fname}: 'vocab' must be a non-empty object "
                         f'mapping token -> id')
    for tok, idx in vocab.items():
        if not isinstance(idx, int) or isinstance(idx, bool) or idx < 0:
            raise ValueError(
                f'{fname}: vocab entry {tok!r} has invalid id {idx!r} '
                f'(want a non-negative integer)')
    ids = list(vocab.values())
    if len(set(ids)) != len(ids):
        dup = next(i for i in ids if ids.count(i) > 1)
        raise ValueError(f'{fname}: duplicate token id {dup} in vocab')
    merges = state.get('merges', [])
    if not isinstance(merges, list):
        raise ValueError(f"{fname}: 'merges' must be a list")
    for m in merges:
        if not (isinstance(m, (list, tuple)) and len(m) == 2
                and all(isinstance(s, str) for s in m)):
            raise ValueError(
                f'{fname}: merge entry {m!r} is not a [left, right] '
                f'string pair')
    return state


class PretrainedTokenizer:
    pad_token = '<pad>'
    unk_token = '<unk>'
    bos_token = '<s>'
    eos_token = '</s>'
    mask_token = '<mask>'

    def __init__(self, vocab: Optional[Dict[str, int]] = None):
        self.vocab: Dict[str, int] = dict(vocab or {})
        for tok in (self.pad_token, self.unk_token, self.bos_token,
                    self.eos_token, self.mask_token):
            if tok not in self.vocab:
                self.vocab[tok] = len(self.vocab)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}

    # -- special ids --------------------------------------------------------
    @property
    def pad_token_id(self):
        return self.vocab[self.pad_token]

    @property
    def unk_token_id(self):
        return self.vocab[self.unk_token]

    @property
    def bos_token_id(self):
        return self.vocab[self.bos_token]

    @property
    def eos_token_id(self):
        return self.vocab[self.eos_token]

    @property
    def vocab_size(self):
        return len(self.vocab)

    def __len__(self):
        return len(self.vocab)

    # -- core API -----------------------------------------------------------
    def tokenize(self, text: str) -> List[str]:
        raise NotImplementedError

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self.vocab.get(tokens, self.unk_token_id)
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    def convert_ids_to_tokens(self, ids):
        if isinstance(ids, int):
            return self.inv_vocab.get(ids, self.unk_token)
        return [self.inv_vocab.get(int(i), self.unk_token) for i in ids]

    def encode(self, text: str, add_special_tokens: bool = False,
               max_length: Optional[int] = None) -> List[int]:
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if add_special_tokens:
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
        if max_length is not None:
            ids = ids[:max_length]
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        special = {self.pad_token_id, self.bos_token_id, self.eos_token_id,
                   self.vocab[self.mask_token]}
        toks = [self.inv_vocab.get(int(i), self.unk_token) for i in ids
                if not (skip_special_tokens and int(i) in special)]
        return self._detokenize(toks)

    def _detokenize(self, tokens: List[str]) -> str:
        return ' '.join(tokens)

    def __call__(self, text, padding: bool = False,
                 max_length: Optional[int] = None,
                 add_special_tokens: bool = False,
                 return_attention_mask: bool = True):
        texts = [text] if isinstance(text, str) else list(text)
        encoded = [self.encode(t, add_special_tokens=add_special_tokens,
                               max_length=max_length) for t in texts]
        if padding:
            width = max_length or max(len(e) for e in encoded)
            masks = [[1] * len(e) + [0] * (width - len(e)) for e in encoded]
            encoded = [e + [self.pad_token_id] * (width - len(e))
                       for e in encoded]
        else:
            masks = [[1] * len(e) for e in encoded]
        out = {'input_ids': encoded[0] if isinstance(text, str) else encoded}
        if return_attention_mask:
            out['attention_mask'] = (masks[0] if isinstance(text, str)
                                     else masks)
        return out

    # -- persistence --------------------------------------------------------
    def _extra_state(self) -> Dict:
        return {}

    def save_pretrained(self, save_dir: str):
        os.makedirs(save_dir, exist_ok=True)
        state = {'class': type(self).__name__, 'vocab': self.vocab}
        state.update(self._extra_state())
        with open(os.path.join(save_dir, 'tokenizer.json'), 'w') as f:
            json.dump(state, f)

    @classmethod
    def from_pretrained(cls, path: str):
        """Load from a local directory. Hub names are rejected offline
        (reference downloads from bos/huggingface; zero-egress here).
        The file schema is validated up front so a malformed directory
        fails with a clear message, not a KeyError mid-load."""
        fname = os.path.join(path, 'tokenizer.json')
        if not os.path.isfile(fname):
            raise OSError(
                f'{path!r} is not a local tokenizer directory (offline '
                f'build: hub downloads are disabled; call save_pretrained '
                f'first)')
        try:
            with open(fname) as f:
                state = json.load(f)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise ValueError(f'{fname}: not valid JSON: {e}') from e
        state = _validate_tokenizer_state(fname, state)
        klass = {c.__name__: c for c in
                 (WhitespaceTokenizer, BPETokenizer)}.get(
                     state.get('class'), cls)
        tok = klass.__new__(klass)
        PretrainedTokenizer.__init__(tok, state['vocab'])
        tok._load_extra_state(state)
        return tok

    def _load_extra_state(self, state: Dict):
        pass


class WhitespaceTokenizer(PretrainedTokenizer):
    def tokenize(self, text: str) -> List[str]:
        return text.strip().split()

    def train_from_iterator(self, it: Iterable[str],
                            vocab_size: Optional[int] = None):
        counts = collections.Counter()
        for line in it:
            counts.update(line.strip().split())
        for tok, _ in counts.most_common(vocab_size):
            if tok not in self.vocab:
                self.vocab[tok] = len(self.vocab)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        return self


_WORD_END = '</w>'


class BPETokenizer(PretrainedTokenizer):
    """Byte-level-ish BPE: characters as base symbols plus byte fallback
    tokens `<0xNN>` so unseen characters still encode."""

    def __init__(self, vocab=None, merges: Optional[Sequence[Tuple[str, str]]] = None):
        super().__init__(vocab)
        self.merges: List[Tuple[str, str]] = [tuple(m) for m in (merges or [])]
        self._ranks = {m: i for i, m in enumerate(self.merges)}
        for i in range(256):
            bt = f'<0x{i:02X}>'
            if bt not in self.vocab:
                self.vocab[bt] = len(self.vocab)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}

    def _extra_state(self):
        return {'merges': [list(m) for m in self.merges]}

    def _load_extra_state(self, state):
        self.merges = [tuple(m) for m in state.get('merges', [])]
        self._ranks = {m: i for i, m in enumerate(self.merges)}

    def _bpe_word(self, word: str) -> List[str]:
        symbols = list(word) + [_WORD_END]
        while len(symbols) > 1:
            pairs = [(self._ranks.get((a, b), 1 << 60), i)
                     for i, (a, b) in enumerate(zip(symbols, symbols[1:]))]
            rank, i = min(pairs)
            if rank >= 1 << 60:
                break
            symbols = symbols[:i] + [symbols[i] + symbols[i + 1]] \
                + symbols[i + 2:]
        return symbols

    def tokenize(self, text: str) -> List[str]:
        out = []
        for word in text.strip().split():
            for sym in self._bpe_word(word):
                if sym in self.vocab:
                    out.append(sym)
                else:  # byte fallback
                    for b in sym.encode('utf-8'):
                        out.append(f'<0x{b:02X}>')
        return out

    def _detokenize(self, tokens: List[str]) -> str:
        text, byte_buf = [], []

        def flush_bytes():
            if byte_buf:
                text.append(bytes(byte_buf).decode('utf-8', errors='replace'))
                byte_buf.clear()
        for t in tokens:
            if t.startswith('<0x') and t.endswith('>') and len(t) == 6:
                byte_buf.append(int(t[3:5], 16))
                continue
            flush_bytes()
            text.append(t)
        flush_bytes()
        return ''.join(text).replace(_WORD_END, ' ').strip()

    def train_from_iterator(self, it: Iterable[str], vocab_size: int = 1000,
                            min_frequency: int = 2):
        word_counts = collections.Counter()
        for line in it:
            word_counts.update(line.strip().split())
        words = {w: list(w) + [_WORD_END] for w in word_counts}
        # seed vocab with single characters
        for w in word_counts:
            for ch in w:
                if ch not in self.vocab:
                    self.vocab[ch] = len(self.vocab)
        if _WORD_END not in self.vocab:
            self.vocab[_WORD_END] = len(self.vocab)
        while len(self.vocab) < vocab_size:
            pair_counts = collections.Counter()
            for w, syms in words.items():
                c = word_counts[w]
                for pair in zip(syms, syms[1:]):
                    pair_counts[pair] += c
            if not pair_counts:
                break
            (a, b), cnt = pair_counts.most_common(1)[0]
            if cnt < min_frequency:
                break
            self.merges.append((a, b))
            merged = a + b
            if merged not in self.vocab:
                self.vocab[merged] = len(self.vocab)
            for w, syms in words.items():
                out, i = [], 0
                while i < len(syms):
                    if i + 1 < len(syms) and syms[i] == a and syms[i + 1] == b:
                        out.append(merged)
                        i += 2
                    else:
                        out.append(syms[i])
                        i += 1
                words[w] = out
        self._ranks = {m: i for i, m in enumerate(self.merges)}
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        return self
