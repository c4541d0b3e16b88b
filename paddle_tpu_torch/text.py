"""paddle.text (counterpart of `paddle_tpu/text.py`; upstream:
python/paddle/text/): ViterbiDecoder plus the dataset surface (offline
build: synthetic deterministic stand-ins, the same seeds and sizes as the
JAX package's).

`viterbi_decode` is a loop over the sequence on the tensors' device: each
step one max/argmax over the [B, T, T] scores, then a backtrace by
`gather`. On the card that is a few launches a step, so its time is set
by launches, not by the arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

from .io import Dataset
from .nn.layer import Layer
from .ops._helpers import defop

__all__ = ['viterbi_decode', 'ViterbiDecoder', 'Imdb', 'UCIHousing',
           'Conll05st']


def viterbi_decode(potentials, transition, lengths, include_bos_eos_tag=True,
                   name=None):
    """Hard Viterbi decode (upstream: paddle.text.viterbi_decode).

    potentials: [B, L, T] unary emissions; transition: [T, T] (row = from);
    lengths: [B] int. With include_bos_eos_tag=True the last two tag rows
    are treated as BOS/EOS like upstream. Returns (scores [B], paths
    [B, L] int64, right-padded with 0 past each length).
    """
    def f(pot, trans, lens):
        b, seq_len, n_tags = pot.shape
        lens = lens.to(pot.device)
        if include_bos_eos_tag:
            bos, eos = n_tags - 2, n_tags - 1
            alpha = pot[:, 0] + trans[bos][None, :]
        else:
            alpha = pot[:, 0]
        ident = torch.arange(n_tags, device=pot.device).expand(b, n_tags)
        backs = []
        for t in range(1, seq_len):
            # [B, Tfrom, Tto]
            scores = alpha[:, :, None] + trans[None, :, :] \
                + pot[:, t][:, None, :]
            best, back = scores.max(dim=1)
            # positions past a sequence's length keep their alpha frozen
            # and an identity backpointer
            active = (t < lens)[:, None]
            alpha = torch.where(active, best, alpha)
            backs.append(torch.where(active, back, ident))
        if include_bos_eos_tag:
            alpha = alpha + trans[:, eos][None, :]
        scores, tag = alpha.max(dim=-1)
        path = [tag]
        for back in reversed(backs):
            tag = back.gather(1, tag[:, None])[:, 0]
            path.append(tag)
        paths = torch.stack(path[::-1], dim=1)          # [B, L]
        # mask past-length positions to 0 (upstream pads with 0)
        pos = torch.arange(seq_len, device=pot.device)[None, :]
        paths = torch.where(pos < lens[:, None], paths, 0)
        return scores, paths.to(torch.int64)
    return defop(f, name='viterbi_decode')(potentials, transition, lengths)


class ViterbiDecoder(Layer):
    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        super().__init__()
        self.transitions = transitions
        self.include_bos_eos_tag = include_bos_eos_tag

    def forward(self, potentials, lengths):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)


# -- datasets (synthetic offline stand-ins) ---------------------------------

class Imdb(Dataset):
    """Binary sentiment surface: token-id sequences + 0/1 labels."""

    def __init__(self, data_file=None, mode='train', cutoff=150, seed=None):
        if data_file is not None:
            raise RuntimeError('offline build: archives unavailable; '
                               'the synthetic stand-in is used instead')
        rng = np.random.RandomState(
            (0 if mode == 'train' else 1) if seed is None else seed)
        n, vocab, length = (256 if mode == 'train' else 64), 5000, 64
        self.labels = rng.randint(0, 2, n).astype(np.int64)
        # class-dependent token distribution so models can fit
        shift = self.labels[:, None] * (vocab // 2)
        self.docs = ((rng.randint(0, vocab // 2, (n, length)) + shift)
                     .astype(np.int64))
        self.word_idx = {f'tok{i}': i for i in range(vocab)}

    def __getitem__(self, i):
        return self.docs[i], self.labels[i]

    def __len__(self):
        return len(self.docs)


class UCIHousing(Dataset):
    """13-feature regression surface with a fixed linear ground truth."""

    def __init__(self, data_file=None, mode='train'):
        if data_file is not None:
            raise RuntimeError('offline build: archives unavailable; '
                               'the synthetic stand-in is used instead')
        rng = np.random.RandomState(0 if mode == 'train' else 1)
        n = 404 if mode == 'train' else 102
        self.x = rng.randn(n, 13).astype(np.float32)
        w = np.linspace(-1, 1, 13).astype(np.float32)
        self.y = (self.x @ w + 0.1 * rng.randn(n)).astype(np.float32)[:, None]

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


class Conll05st(Dataset):
    """SRL-shaped surface: (tokens, predicate-mark, labels) triples."""

    N_TAGS = 9

    def __init__(self, data_file=None, mode='train'):
        if data_file is not None:
            raise RuntimeError('offline build: archives unavailable; '
                               'the synthetic stand-in is used instead')
        rng = np.random.RandomState(0 if mode == 'train' else 1)
        n, vocab, length = (128 if mode == 'train' else 32), 2000, 32
        self.tokens = rng.randint(0, vocab, (n, length)).astype(np.int64)
        self.marks = (rng.rand(n, length) < 0.1).astype(np.int64)
        self.labels = ((self.tokens + self.marks * 3) % self.N_TAGS) \
            .astype(np.int64)

    def __getitem__(self, i):
        return self.tokens[i], self.marks[i], self.labels[i]

    def __len__(self):
        return len(self.tokens)
