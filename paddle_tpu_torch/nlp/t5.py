"""The T5 encoder-decoder family (counterpart of `paddle_tpu/nlp/t5.py`),
with the same `state_dict` keys and shapes: relative position bias,
RMSNorm, unscaled attention, and by default a head tied to the shared
embedding with the d_model**-0.5 logit scale.

Attention goes through `F.scaled_dot_product_attention`. T5 is
unscaled, so q is multiplied by sqrt(d_kv) first (exact: a power of two
at d_kv 64 and 16), as the JAX model does, and the kernels keep their
own 1/sqrt(d) scale. Self-attention always carries the position bias as
an additive f32 `attn_mask` (with the causal and padding terms), so it
takes the plain attention, as the JAX package sends masked attention to
XLA. Cross-attention without an encoder mask has no bias: at d_kv >= 64
it runs the flash kernels (non-causal, Sq != Sk), in training their
backward too. Every norm is an `RMSNorm` (the RMSNorm kernel) and the
loss is `F.cross_entropy` (the fused CE kernels).

The bucket of a relative position is the JAX model's f32 expression
(`_relative_position_bucket`). It is computed once per
(bidirectional, buckets, max distance) on the host, over the relative
positions [-max_distance, max_distance] (every position past them
falls in the last bucket), and the forward gathers from that table on
the model's device: a position's bucket is then the same on every
device, where a log computed on the card could round one ulp away from
the CPU's at the bucket edges (n = 16, 32, 64 at 32 buckets over 128).

The decode forward of `Seq2SeqGenerationMixin` passes the static
self-attention cache (`init_cache`) with `cache_offset` (the slot of
the first token, an int or a 0-d tensor) and each layer's cross K/V
(`cross_kv`), computed once per `generate()` call. With
`config.use_recompute` and grad enabled (training, no cache) each block
runs under `torch.utils.checkpoint` (non-reentrant), as the JAX model's
`jax.checkpoint`; the kernels rerun in the recompute count their
launches again.

The models take `device=` (default `cuda`, raising without a card),
`dtype=` and `generator=` for their random weights (Paddle's defaults:
Xavier-uniform projections, Xavier-normal embeddings, unit norms). T5
runs in f32 and bf16: its FF overflows fp16, and the JAX package clamps
nothing.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import amp as _amp
from ..dtype import to_torch_dtype
from ..nn import functional as F
from ..nn.common_layers import Dropout, Embedding, Linear
from ..nn.layer import Layer, init_kwargs
from ..nn.norm import RMSNorm
from ..tensor import to_torch
from .generation import Seq2SeqGenerationMixin, as_offset, update_static_cache

_NEG = -1e9


class T5Config:
    model_type = 't5'

    def __init__(self, vocab_size=32128, d_model=512, d_kv=64, d_ff=2048,
                 num_layers=6, num_decoder_layers=None, num_heads=8,
                 relative_attention_num_buckets=32,
                 relative_attention_max_distance=128, dropout_rate=0.1,
                 layer_norm_epsilon=1e-6, feed_forward_proj='relu',
                 tie_word_embeddings=True, pad_token_id=0, eos_token_id=1,
                 decoder_start_token_id=0, tensor_parallel=False,
                 sequence_parallel=False, use_recompute=False, **kwargs):
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.d_kv = d_kv
        self.d_ff = d_ff
        self.num_layers = num_layers
        self.num_decoder_layers = (num_decoder_layers
                                   if num_decoder_layers is not None
                                   else num_layers)
        self.num_heads = num_heads
        self.relative_attention_num_buckets = relative_attention_num_buckets
        self.relative_attention_max_distance = relative_attention_max_distance
        self.dropout_rate = dropout_rate
        self.layer_norm_epsilon = layer_norm_epsilon
        self.feed_forward_proj = feed_forward_proj
        self.tie_word_embeddings = tie_word_embeddings
        self.pad_token_id = pad_token_id
        self.eos_token_id = eos_token_id
        self.decoder_start_token_id = decoder_start_token_id
        self.tensor_parallel = tensor_parallel
        self.sequence_parallel = sequence_parallel
        self.use_recompute = use_recompute
        for k, v in kwargs.items():
            setattr(self, k, v)

    @property
    def is_gated_act(self):
        return self.feed_forward_proj.startswith('gated-')

    @property
    def dense_act_fn(self):
        return self.feed_forward_proj.split('-')[-1]

    @classmethod
    def t5_small(cls, **kw):
        return cls(d_model=512, d_kv=64, d_ff=2048, num_layers=6,
                   num_heads=8, **kw)

    @classmethod
    def t5_base(cls, **kw):
        return cls(d_model=768, d_kv=64, d_ff=3072, num_layers=12,
                   num_heads=12, **kw)

    @classmethod
    def t5_large(cls, **kw):
        return cls(d_model=1024, d_kv=64, d_ff=4096, num_layers=24,
                   num_heads=16, **kw)

    @classmethod
    def t5_v1_1_base(cls, **kw):
        return cls(d_model=768, d_kv=64, d_ff=2048, num_layers=12,
                   num_heads=12, feed_forward_proj='gated-gelu',
                   tie_word_embeddings=False, **kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault('vocab_size', 96)
        kw.setdefault('d_model', 64)
        kw.setdefault('d_kv', 16)
        kw.setdefault('d_ff', 128)
        kw.setdefault('num_layers', 2)
        kw.setdefault('num_heads', 4)
        kw.setdefault('relative_attention_num_buckets', 8)
        kw.setdefault('relative_attention_max_distance', 16)
        kw.setdefault('dropout_rate', 0.0)
        return cls(**kw)


def _relative_position_bucket(rel: torch.Tensor, bidirectional: bool,
                              num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """T5's log-bucketed relative positions (`rel` = memory_pos -
    query_pos, integers of any shape), the JAX model's expression in f32:
    log(n / max_exact), divided by the f32-rounded log(max_distance /
    max_exact), times (buckets - max_exact), truncated."""
    rel = rel.long()
    ret = torch.zeros_like(rel)
    n = -rel
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).long() * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    nf = n.clamp(min=1).float()
    denom = torch.tensor(math.log(max_distance / max_exact),
                         dtype=torch.float32)
    scaled = torch.log(nf / float(max_exact)) / denom \
        * float(num_buckets - max_exact)
    large = (max_exact + scaled.long()).clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, large)


def bucket_table(bidirectional: bool, num_buckets: int,
                 max_distance: int) -> torch.Tensor:
    """The bucket of each relative position in [-max_distance,
    max_distance] (index rel + max_distance), computed on the host; a
    position past either end has the end's bucket."""
    rel = torch.arange(-max_distance, max_distance + 1)
    return _relative_position_bucket(rel, bidirectional, num_buckets,
                                     max_distance)


class T5Attention(Layer):
    """Unscaled multi-head attention with an optional learned relative
    position bias; inner width num_heads * d_kv (apart from d_model)."""

    def __init__(self, config: T5Config, has_relative_attention_bias=False,
                 bidirectional=True, **init):
        super().__init__()
        self.config = config
        self.bidirectional = bidirectional
        self.num_heads = config.num_heads
        self.d_kv = config.d_kv
        inner = config.num_heads * config.d_kv
        self.q = Linear(config.d_model, inner, bias_attr=False, **init)
        self.k = Linear(config.d_model, inner, bias_attr=False, **init)
        self.v = Linear(config.d_model, inner, bias_attr=False, **init)
        self.o = Linear(inner, config.d_model, bias_attr=False, **init)
        self.relative_attention_bias = None
        self._tables = {}
        if has_relative_attention_bias:
            self.relative_attention_bias = Embedding(
                config.relative_attention_num_buckets, config.num_heads,
                **init)
            # the bucket table, on the host and on each device it was
            # gathered on
            self._tables['cpu'] = bucket_table(
                bidirectional, config.relative_attention_num_buckets,
                config.relative_attention_max_distance)

    def _table(self, device) -> torch.Tensor:
        t = self._tables.get(str(device))
        if t is None:
            t = self._tables['cpu'].to(device)
            # while torch.export traces, t is its stand-in, not a table
            if not torch.compiler.is_exporting():
                self._tables[str(device)] = t
        return t

    def buckets(self, query_length: int, key_length: int,
                query_offset=0) -> torch.Tensor:
        """[Sq, Sk] bucket ids of the query positions query_offset + i
        (an int or a 0-d tensor) against the key positions j."""
        dev = self.relative_attention_bias.weight.device
        md = self.config.relative_attention_max_distance
        ctx = as_offset(query_offset, dev) + torch.arange(query_length,
                                                          device=dev)
        mem = torch.arange(key_length, device=dev)
        rel = (mem[None, :] - ctx[:, None]).clamp(-md, md)
        return self._table(dev)[rel + md]

    def compute_bias(self, query_length: int, key_length: int,
                     query_offset=0) -> torch.Tensor:
        """[1, H, Sq, Sk] additive bias, in the weight's dtype."""
        w = self.relative_attention_bias.weight
        return w[self.buckets(query_length, key_length,
                              query_offset)].permute(2, 0, 1)[None]

    def _split(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(t.shape[0], t.shape[1], self.num_heads, self.d_kv)

    def forward(self, hidden, key_value_states=None, bias=None, cache=None,
                cache_offset=None):
        """bias: additive float [.., H|1, Sq|1, Sk] (position bias and
        padding or causal terms), already combined by the caller. cache:
        the self-attention's static (k, v) cache, written at
        `cache_offset`, or the cross-attention's precomputed (k, v) used
        as it is (`key_value_states` None marks self-attention). Returns
        the output, and with a self-attention cache (output, (k, v))."""
        q = self._split(self.q(hidden)) * math.sqrt(self.d_kv)
        new_cache = None
        if key_value_states is not None:        # cross-attention
            if cache is not None:
                kh, vh = cache
            else:
                kh = self._split(self.k(key_value_states))
                vh = self._split(self.v(key_value_states))
        else:                                   # self-attention
            kh = self._split(self.k(hidden))
            vh = self._split(self.v(hidden))
            if cache is not None:
                kh, vh = new_cache = update_static_cache(
                    cache[0], cache[1], kh, vh, cache_offset)
        out = F.scaled_dot_product_attention(q, kh, vh, attn_mask=bias)
        out = self.o(out.reshape(out.shape[0], out.shape[1],
                                 self.num_heads * self.d_kv))
        if new_cache is not None:
            return out, new_cache
        return out


class T5DenseFF(Layer):

    def __init__(self, config: T5Config, **init):
        super().__init__()
        self.config = config
        self.act = {'relu': F.relu,
                    'gelu': functools.partial(F.gelu, approximate=True),
                    'silu': F.silu}[config.dense_act_fn]
        if config.is_gated_act:
            self.wi_0 = Linear(config.d_model, config.d_ff, bias_attr=False,
                               **init)
            self.wi_1 = Linear(config.d_model, config.d_ff, bias_attr=False,
                               **init)
        else:
            self.wi = Linear(config.d_model, config.d_ff, bias_attr=False,
                             **init)
        self.wo = Linear(config.d_ff, config.d_model, bias_attr=False, **init)
        self.dropout = Dropout(config.dropout_rate)

    def forward(self, x):
        if self.config.is_gated_act:
            h = self.act(self.wi_0(x)) * self.wi_1(x)
        else:
            h = self.act(self.wi(x))
        return self.wo(self.dropout(h))


class T5Block(Layer):
    """Pre-norm residual block: norm -> sublayer -> dropout -> add.
    Encoder: self-attention + FF. Decoder: self-attention +
    cross-attention + FF."""

    def __init__(self, config: T5Config, is_decoder,
                 has_relative_attention_bias=False, **init):
        super().__init__()
        norm = {k: init[k] for k in ('device', 'dtype')}
        eps = config.layer_norm_epsilon
        self.is_decoder = is_decoder
        self.self_attn = T5Attention(
            config, has_relative_attention_bias=has_relative_attention_bias,
            bidirectional=not is_decoder, **init)
        self.self_attn_norm = RMSNorm(config.d_model, epsilon=eps, **norm)
        if is_decoder:
            self.cross_attn = T5Attention(config, bidirectional=True, **init)
            self.cross_attn_norm = RMSNorm(config.d_model, epsilon=eps,
                                           **norm)
        self.ff = T5DenseFF(config, **init)
        self.ff_norm = RMSNorm(config.d_model, epsilon=eps, **norm)
        self.dropout = Dropout(config.dropout_rate)

    def forward(self, hidden, self_bias=None, encoder_hidden=None,
                cross_bias=None, cache=None, cache_offset=None,
                cross_kv=None):
        out = self.self_attn(self.self_attn_norm(hidden), bias=self_bias,
                             cache=cache, cache_offset=cache_offset)
        new_cache = None
        if cache is not None:
            out, new_cache = out
        h = hidden + self.dropout(out)
        if self.is_decoder:
            c = self.cross_attn(self.cross_attn_norm(h),
                                key_value_states=encoder_hidden,
                                bias=cross_bias, cache=cross_kv)
            h = h + self.dropout(c)
        h = h + self.dropout(self.ff(self.ff_norm(h)))
        if cache is not None:
            return h, new_cache
        return h


def _pad_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, S] keep-mask -> [B, 1, 1, S] additive 0 / -1e9 f32 bias."""
    return torch.where((mask > 0)[:, None, None, :], 0.0,
                       _NEG).to(torch.float32)


class T5Stack(Layer):

    def __init__(self, config: T5Config, is_decoder, **init):
        super().__init__()
        self.config = config
        self.is_decoder = is_decoder
        n = config.num_decoder_layers if is_decoder else config.num_layers
        self.block = torch.nn.ModuleList(
            T5Block(config, is_decoder, has_relative_attention_bias=(i == 0),
                    **init) for i in range(n))
        self.final_layer_norm = RMSNorm(config.d_model,
                                        epsilon=config.layer_norm_epsilon,
                                        device=init['device'],
                                        dtype=init['dtype'])
        self.dropout = Dropout(config.dropout_rate)

    def _self_bias(self, s: int, attention_mask, cache, cache_offset):
        """The self-attention's f32 bias: the position bias, plus (with a
        cache) the slot-causal term over the whole static cache, else
        (decoder) the causal term and the padding term."""
        attn = self.block[0].self_attn
        if cache is not None:
            total = cache[0][0].shape[1]
            slot = as_offset(cache_offset, cache[0][0].device)
            dev = slot.device
            valid = (torch.arange(total, device=dev)[None, :]
                     <= (slot + torch.arange(s, device=dev))[:, None])
            return attn.compute_bias(s, total, slot).float() + torch.where(
                valid, 0.0, _NEG)[None, None]
        bias = attn.compute_bias(s, s).float()
        if self.is_decoder:
            ar = torch.arange(s, device=bias.device)
            bias = bias + torch.where(ar[None, :] <= ar[:, None], 0.0,
                                      _NEG)[None, None]
        if attention_mask is not None:
            bias = bias + _pad_bias(attention_mask)
        return bias

    def forward(self, embeds, attention_mask=None, encoder_hidden=None,
                encoder_attention_mask=None, cache=None, cache_offset=None,
                cross_kv=None):
        """Returns the final hidden states, and with `cache` (hidden,
        per-layer updated caches)."""
        h = self.dropout(embeds)
        self_bias = self._self_bias(h.shape[1], attention_mask, cache,
                                    cache_offset)
        cross_bias = None
        if self.is_decoder and encoder_attention_mask is not None:
            cross_bias = _pad_bias(encoder_attention_mask)
        remat = (self.config.use_recompute and cache is None
                 and torch.is_grad_enabled())
        new_caches = []
        for i, blk in enumerate(self.block):
            if remat:
                h = checkpoint(_amp.keep_policy(blk), h, self_bias,
                               encoder_hidden, cross_bias,
                               use_reentrant=False)
                continue
            out = blk(h, self_bias=self_bias, encoder_hidden=encoder_hidden,
                      cross_bias=cross_bias,
                      cache=None if cache is None else cache[i],
                      cache_offset=cache_offset,
                      cross_kv=None if cross_kv is None else cross_kv[i])
            if cache is not None:
                h, c = out
                new_caches.append(c)
            else:
                h = out
        h = self.dropout(self.final_layer_norm(h))
        if cache is not None:
            return h, new_caches
        return h


class T5Model(Layer):
    """The shared embedding, then the encoder stack, then the decoder
    stack with cross-attention (the JAX `T5Model`)."""

    def __init__(self, config: T5Config, *, device=None, dtype='float32',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.tensor_parallel or config.sequence_parallel:
            raise NotImplementedError(
                'T5 with tensor_parallel / sequence_parallel is not ported '
                'yet (ROADMAP.md, Queue 1, item 4.7: distributed/)')
        init = init_kwargs(device, dtype, generator)
        self.config = config
        self.shared = Embedding(config.vocab_size, config.d_model, **init)
        self.encoder = T5Stack(config, is_decoder=False, **init)
        self.decoder = T5Stack(config, is_decoder=True, **init)

    @property
    def device(self) -> torch.device:
        return self.shared.weight.device

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(to_torch(ids), device=self.device)

    def encode(self, input_ids, attention_mask=None):
        if attention_mask is not None:
            attention_mask = self._ids(attention_mask)
        return self.encoder(self.shared(self._ids(input_ids)),
                            attention_mask=attention_mask)

    def decode(self, decoder_input_ids, encoder_hidden,
               encoder_attention_mask=None, decoder_attention_mask=None,
               cache=None, cache_offset=None, cross_kv=None):
        if encoder_attention_mask is not None:
            encoder_attention_mask = self._ids(encoder_attention_mask)
        if decoder_attention_mask is not None:
            decoder_attention_mask = self._ids(decoder_attention_mask)
        return self.decoder(self.shared(self._ids(decoder_input_ids)),
                            attention_mask=decoder_attention_mask,
                            encoder_hidden=encoder_hidden,
                            encoder_attention_mask=encoder_attention_mask,
                            cache=cache, cache_offset=cache_offset,
                            cross_kv=cross_kv)

    def forward(self, input_ids, decoder_input_ids, attention_mask=None,
                decoder_attention_mask=None):
        """(decoder hidden states, encoder hidden states)."""
        enc = self.encode(input_ids, attention_mask=attention_mask)
        return self.decode(decoder_input_ids, enc,
                           encoder_attention_mask=attention_mask,
                           decoder_attention_mask=decoder_attention_mask), enc

    def init_cache(self, batch_size: int, max_length: int, dtype=None):
        """Per-decoder-layer (K, V) zeros [batch_size, max_length, H,
        d_kv] on the model's device, in `dtype` (default the weights')."""
        cfg = self.config
        w = self.shared.weight
        dt = w.dtype if dtype is None else to_torch_dtype(dtype)
        shape = (batch_size, int(max_length), cfg.num_heads, cfg.d_kv)
        return [(torch.zeros(shape, dtype=dt, device=w.device),
                 torch.zeros(shape, dtype=dt, device=w.device))
                for _ in range(cfg.num_decoder_layers)]

    def cross_kv(self, encoder_hidden):
        """Each decoder layer's cross-attention (K, V) [B, S_enc, H,
        d_kv] from the encoder output: computed once per generate()."""
        return [(blk.cross_attn._split(blk.cross_attn.k(encoder_hidden)),
                 blk.cross_attn._split(blk.cross_attn.v(encoder_hidden)))
                for blk in self.decoder.block]


class T5ForConditionalGeneration(Layer, Seq2SeqGenerationMixin):
    """T5 with its LM head: tied to the shared embedding (logits =
    (h * d_model**-0.5) @ shared.T, the scale only in the tied
    configuration) or an untied bias-free `lm_head`."""

    def __init__(self, config: T5Config, *, device=None, dtype='float32',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.t5 = T5Model(config, device=device, dtype=dtype,
                          generator=generator)
        w = self.t5.shared.weight
        self.lm_head = None if config.tie_word_embeddings else Linear(
            config.d_model, config.vocab_size, bias_attr=False,
            device=w.device, dtype=w.dtype, generator=generator)

    @property
    def device(self) -> torch.device:
        return self.t5.shared.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.t5.shared.weight.dtype

    def _shift_right(self, labels) -> torch.Tensor:
        """labels -> decoder inputs: decoder_start prepended, the last
        dropped, ignore_index (-100) mapped to pad."""
        cfg = self.config
        lab = torch.as_tensor(labels, device=self.device)
        shifted = torch.cat([torch.full((lab.shape[0], 1),
                                        cfg.decoder_start_token_id,
                                        dtype=lab.dtype, device=lab.device),
                             lab[:, :-1]], dim=1)
        return torch.where(shifted == -100, cfg.pad_token_id, shifted)

    def _logits(self, h):
        if self.lm_head is not None:
            return self.lm_head(h)
        # the tied head scales h first (the JAX model's order)
        scale = self.config.d_model ** -0.5
        return torch.matmul(h * scale, self.t5.shared.weight.t())

    def forward(self, input_ids=None, decoder_input_ids=None,
                attention_mask=None, decoder_attention_mask=None,
                labels=None, encoder_output=None, encoder_cross_kv=None,
                cache=None, cache_offset=None, use_cache=False):
        """Logits [B, S_dec, V]; with `labels` (loss, logits), the
        decoder inputs `_shift_right(labels)` unless given; with
        `use_cache` (logits, updated caches)."""
        if labels is not None:
            labels = torch.as_tensor(labels, device=self.device)
            if decoder_input_ids is None:
                decoder_input_ids = self._shift_right(labels)
        if encoder_output is None:
            encoder_output = self.t5.encode(input_ids,
                                            attention_mask=attention_mask)
        out = self.t5.decode(decoder_input_ids, encoder_output,
                             encoder_attention_mask=attention_mask,
                             decoder_attention_mask=decoder_attention_mask,
                             cache=cache, cache_offset=cache_offset,
                             cross_kv=encoder_cross_kv)
        h, new_cache = out if cache is not None else (out, None)
        logits = self._logits(h)
        if labels is not None:
            loss = F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                                   labels.reshape(-1))
            return loss, logits
        if use_cache:
            return logits, new_cache
        return logits

    # --- Seq2SeqGenerationMixin's protocol ---------------------------------
    def init_cache(self, batch_size: int, max_length: int, dtype=None):
        return self.t5.init_cache(batch_size, max_length, dtype)

    def encode(self, input_ids, attention_mask=None):
        return self.t5.encode(input_ids, attention_mask=attention_mask)

    def cross_kv(self, encoder_hidden):
        return self.t5.cross_kv(encoder_hidden)


__all__ = ['T5Config', 'T5Attention', 'T5DenseFF', 'T5Block', 'T5Stack',
           'T5Model', 'T5ForConditionalGeneration', 'bucket_table']
