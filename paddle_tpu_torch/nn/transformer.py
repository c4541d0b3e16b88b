"""Transformer layers (counterpart of `paddle_tpu/nn/transformer.py`):
`MultiHeadAttention` (with its incremental `Cache` and cross-attention
`StaticCache`), `TransformerEncoderLayer`, `TransformerEncoder`,
`TransformerDecoderLayer`, `TransformerDecoder` and `Transformer`, with
the JAX package's parameter names and Paddle's [batch, seq, embed]
layout.

Attention goes through `F.scaled_dot_product_attention`: unmasked calls
without dropout and with head_dim >= 64 take the flash kernels, masked
ones (and attention dropout while training) the plain version, as in
the JAX package. The constructors take the port's `device=`, `dtype=`
and `generator=` beside Paddle's arguments; a `TransformerEncoder` or
`TransformerDecoder` repeats deep copies of the layer it is given, so
its layers start from equal weights, as Paddle's do.
"""
from __future__ import annotations

import collections
import copy

import torch

from . import functional as F
from .common_layers import Dropout, LayerList, Linear
from .layer import Layer
from .norm import LayerNorm

Cache = collections.namedtuple('Cache', ['k', 'v'])
StaticCache = collections.namedtuple('StaticCache', ['k', 'v'])


def _norm_init(init: dict) -> dict:
    return {k: init[k] for k in ('device', 'dtype') if k in init}


class MultiHeadAttention(Layer):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, **init):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f'embed_dim {embed_dim} is not a multiple of '
                             f'num_heads {num_heads}')
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **init)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr, **init)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr, **init)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **init)

    def _split(self, t):
        return t.reshape(t.shape[0], t.shape[1], self.num_heads,
                         self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._split(self.q_proj(query))
        if isinstance(cache, StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split(self.k_proj(key))
            v = self._split(self.v_proj(value))
            if isinstance(cache, Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        if cache is not None and not isinstance(cache, StaticCache):
            return out, Cache(k, v)
        return out

    def gen_cache(self, key, value=None, type=None):
        if type is StaticCache or (value is not None and type is None):
            val = value if value is not None else key
            return StaticCache(self._split(self.k_proj(key)),
                               self._split(self.v_proj(val)))
        z = key.new_zeros((key.shape[0], 0, self.num_heads, self.head_dim))
        return Cache(z, z)


def _activation(name):
    return {'relu': F.relu, 'gelu': F.gelu, 'silu': F.silu}[name]


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation='relu', attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, **init):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout if attn_dropout is not None
            else dropout, **init)
        self.linear1 = Linear(d_model, dim_feedforward, **init)
        self.linear2 = Linear(dim_feedforward, d_model, **init)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps,
                               **_norm_init(init))
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps,
                               **_norm_init(init))
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout_act = Dropout(
            act_dropout if act_dropout is not None else dropout)
        self.activation = _activation(activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, attn_mask=src_mask)
        else:
            src, cache = self.self_attn(src, src, src, attn_mask=src_mask,
                                        cache=cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout_act(self.activation(
            self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer if i == 0 else copy.deepcopy(encoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        out = src
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                out = layer(out, src_mask=src_mask)
            else:
                out, c = layer(out, src_mask=src_mask, cache=cache[i])
                new_caches.append(c)
        if self.norm is not None:
            out = self.norm(out)
        return out if cache is None else (out, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation='relu', attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 **init):
        super().__init__()
        self.normalize_before = normalize_before
        ad = attn_dropout if attn_dropout is not None else dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=ad,
                                            **init)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout=ad,
                                             **init)
        self.linear1 = Linear(d_model, dim_feedforward, **init)
        self.linear2 = Linear(dim_feedforward, d_model, **init)
        self.norm1 = LayerNorm(d_model, **_norm_init(init))
        self.norm2 = LayerNorm(d_model, **_norm_init(init))
        self.norm3 = LayerNorm(d_model, **_norm_init(init))
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.dropout_act = Dropout(
            act_dropout if act_dropout is not None else dropout)
        self.activation = _activation(activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, attn_mask=tgt_mask)
            inc_cache = None
        else:
            tgt, inc_cache = self.self_attn(tgt, tgt, tgt,
                                            attn_mask=tgt_mask,
                                            cache=cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        static = cache[1] if cache is not None else None
        tgt = self.cross_attn(tgt, memory, memory, attn_mask=memory_mask,
                              cache=static)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout_act(self.activation(
            self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (inc_cache, static))

    def gen_cache(self, memory):
        return (self.self_attn.gen_cache(memory),
                self.cross_attn.gen_cache(memory, memory, type=StaticCache))


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer if i == 0 else copy.deepcopy(decoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        out = tgt
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                out = layer(out, memory, tgt_mask, memory_mask)
            else:
                out, c = layer(out, memory, tgt_mask, memory_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            out = self.norm(out)
        return out if cache is None else (out, new_caches)

    def gen_cache(self, memory):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation='relu', attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, **init):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, **init)
            enc_norm = LayerNorm(d_model, **_norm_init(init)) \
                if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, **init)
            dec_norm = LayerNorm(d_model, **_norm_init(init)) \
                if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)
        self.d_model, self.nhead = d_model, nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """[length, length] fp32: 0 on and below the diagonal, -inf
        above."""
        from .. import framework
        dev = framework.current_device() if device is None else device
        return torch.triu(torch.full((length, length), float('-inf'),
                                     device=dev), diagonal=1)


__all__ = ['Cache', 'StaticCache', 'MultiHeadAttention',
           'TransformerEncoderLayer', 'TransformerEncoder',
           'TransformerDecoderLayer', 'TransformerDecoder', 'Transformer']
