"""The GPT family (counterpart of `paddle_tpu/nlp/gpt.py`), with the same
`state_dict` keys and shapes: a pre-LN transformer with learned position
embeddings, a fused `qkv_proj` [h, 3h], a two-matrix MLP (`linear1`,
`linear2`) with biases, and by default a head tied to the word
embeddings.

`qkv_proj`'s output splits as three contiguous blocks [q | k | v] of
num_heads x head_dim each (`paddle_tpu/nlp/gpt.py:97-102`), not per
head. Positions are clipped at 0 (`gpt.py:176-179`); a model serves at
most `max_position_embeddings` positions (the engine's `max_length`).

The forward modes are Llama's (`nlp/llama.py`): the causal no-cache
forward through the flash kernels (also the engine's whole prefill,
which takes each layer's new K/V rows); the paged decode of [N] slots
and the paged chunk of one slot (`generation.paged_attend`: the paged
kernel, or the flash kernel with the key count on the device); and
`GenerationMixin`'s static dense cache (`cache`, `cache_offset`,
`use_cache`), whose masked attention is the plain version. A masked
forward (`attention_mask`) and attention dropout
(`attention_probs_dropout_prob` while training) take the plain
attention, as the JAX package sends both to XLA; hidden dropout runs on
the framework's generator. `labels` give the mean cross-entropy through
the CE kernels (no shift, as in the JAX package).

Random weights are Paddle's defaults (Xavier-uniform projections, a
Xavier-normal embedding, zero biases, unit LayerNorms) drawn on `device`
(default `cuda`, raising without a card) from `generator`.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..dtype import to_torch_dtype
from ..nn import functional as F
from ..nn.common_layers import Dropout, Embedding, Linear
from ..nn.layer import Layer, init_kwargs
from ..nn.norm import LayerNorm
from .generation import (GenerationMixin, as_offset, attend_static,
                         offset_grid, pad_mask, paged_attend, round_kv)


class GPTConfig:
    model_type = 'gpt'

    def __init__(self, vocab_size=50304, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=None, hidden_act='gelu',
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=1024, initializer_range=0.02,
                 layer_norm_epsilon=1e-5, pad_token_id=0, eos_token_id=50256,
                 bos_token_id=50256, tie_word_embeddings=True, **kwargs):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.initializer_range = initializer_range
        self.layer_norm_epsilon = layer_norm_epsilon
        self.pad_token_id = pad_token_id
        self.eos_token_id = eos_token_id
        self.bos_token_id = bos_token_id
        self.tie_word_embeddings = tie_word_embeddings
        for k, v in kwargs.items():
            setattr(self, k, v)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def gpt3_1p3b(cls, **kw):
        """GPT-3 XL (1.3B): 24 layers, d_model 2048, 16 heads x 128."""
        return cls(vocab_size=50304, hidden_size=2048, num_hidden_layers=24,
                   num_attention_heads=16, max_position_embeddings=2048, **kw)

    @classmethod
    def gpt2_small(cls, **kw):
        """GPT-2 small: 12 layers, d_model 768, 12 heads x 64."""
        return cls(vocab_size=50304, hidden_size=768, num_hidden_layers=12,
                   num_attention_heads=12, **kw)

    @classmethod
    def tiny(cls, **kw):
        """Test-sized config (the JAX package's `GPTConfig.tiny`)."""
        kw.setdefault('vocab_size', 128)
        kw.setdefault('hidden_size', 64)
        kw.setdefault('num_hidden_layers', 2)
        kw.setdefault('num_attention_heads', 4)
        kw.setdefault('max_position_embeddings', 128)
        kw.setdefault('hidden_dropout_prob', 0.0)
        kw.setdefault('attention_probs_dropout_prob', 0.0)
        return cls(**kw)


def split_qkv(qkv: torch.Tensor, nh: int, hd: int) -> tuple:
    """q, k, v [B, S, nh, hd] of a fused [B, S, 3 nh hd] projection: three
    contiguous blocks, as the JAX model splits it."""
    b, s = qkv.shape[:2]
    return tuple(qkv[..., i * nh * hd:(i + 1) * nh * hd].reshape(b, s, nh, hd)
                 for i in range(3))


class GPTAttention(Layer):

    def __init__(self, config: GPTConfig, **init):
        super().__init__()
        h, nh = config.hidden_size, config.num_attention_heads
        self.num_heads = nh
        self.head_dim = config.head_dim
        self.qkv_proj = Linear(h, 3 * h, **init)
        self.out_proj = Linear(h, h, **init)
        self.dropout_p = config.attention_probs_dropout_prob

    def forward(self, hidden, position_offset=None, attn_mask=None,
                cache=None, cache_offset=None, kv_pages=None, table=None,
                floor=None, kv_dtype=None):
        """Returns (output, (k, v)): k/v are this call's new rows [B, S,
        H, D], or with `cache` the updated (K, V) cache; `kv_dtype` as in
        `LlamaAttention.forward`."""
        b, s, _ = hidden.shape
        nh, hd = self.num_heads, self.head_dim
        offset = as_offset(position_offset, hidden.device)
        q, k, v = split_qkv(self.qkv_proj(hidden), nh, hd)
        kv = (k, v)
        if cache is not None:
            out, kv = attend_static(q, k, v, cache, offset, cache_offset,
                                    attn_mask)
        elif kv_pages is not None:
            out = paged_attend(q, k, v, kv_pages, table, offset, floor,
                               kv_dtype)
        else:
            k, v = round_kv(k, kv_dtype), round_kv(v, kv_dtype)
            kv = (k, v)
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, is_causal=True,
                dropout_p=self.dropout_p, training=self.training)
        return self.out_proj(out.reshape(b, s, nh * hd)), kv


class GPTDecoderLayer(Layer):

    def __init__(self, config: GPTConfig, **init):
        super().__init__()
        norm_init = {k: init[k] for k in ('device', 'dtype')}
        h = config.hidden_size
        self.norm1 = LayerNorm(h, epsilon=config.layer_norm_epsilon,
                               **norm_init)
        self.attn = GPTAttention(config, **init)
        self.norm2 = LayerNorm(h, epsilon=config.layer_norm_epsilon,
                               **norm_init)
        self.linear1 = Linear(h, config.intermediate_size, **init)
        self.linear2 = Linear(config.intermediate_size, h, **init)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.act = {'gelu': F.gelu, 'relu': F.relu}[config.hidden_act]

    def forward(self, hidden, position_offset=None, attn_mask=None,
                cache=None, cache_offset=None, kv_pages=None, table=None,
                floor=None, kv_dtype=None):
        out, kv = self.attn(self.norm1(hidden),
                            position_offset=position_offset,
                            attn_mask=attn_mask, cache=cache,
                            cache_offset=cache_offset, kv_pages=kv_pages,
                            table=table, floor=floor, kv_dtype=kv_dtype)
        h = hidden + self.dropout(out)
        h = h + self.dropout(self.linear2(self.act(self.linear1(
            self.norm2(h)))))
        return h, kv


class GPTModel(Layer):
    """Embeddings (word + learned position) -> decoder layers -> final
    LayerNorm, on `device` (default `cuda`; raises without a card)."""

    def __init__(self, config: GPTConfig, *, device=None, dtype='float32',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        init = init_kwargs(device, dtype, generator)
        self.config = config
        self.word_embeddings = Embedding(config.vocab_size,
                                         config.hidden_size, **init)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, config.hidden_size, **init)
        self.embed_dropout = Dropout(config.hidden_dropout_prob)
        self.layers = torch.nn.ModuleList(
            GPTDecoderLayer(config, **init)
            for _ in range(config.num_hidden_layers))
        self.final_norm = LayerNorm(config.hidden_size,
                                    epsilon=config.layer_norm_epsilon,
                                    device=init['device'],
                                    dtype=init['dtype'])

    def forward(self, input_ids, position_offset=None, attention_mask=None,
                cache=None, cache_offset=None, kv_pages=None, table=None,
                floor=None,
                kv_dtype=None) -> Tuple[torch.Tensor, List[tuple]]:
        """Returns (final hidden states, per-layer (k, v) new rows, or
        with `cache` the updated caches)."""
        offset = as_offset(position_offset, input_ids.device)
        pos = offset_grid(offset, input_ids.shape[1]).clamp(min=0)
        h = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        h = self.embed_dropout(h)
        mask = pad_mask(attention_mask)
        kvs = []
        for i, layer in enumerate(self.layers):
            h, kv = layer(h, position_offset=offset, attn_mask=mask,
                          cache=None if cache is None else cache[i],
                          cache_offset=cache_offset,
                          kv_pages=None if kv_pages is None else kv_pages[i],
                          table=table, floor=floor, kv_dtype=kv_dtype)
            kvs.append(kv)
        return self.final_norm(h), kvs

    def init_cache(self, batch_size: int, max_length: int, dtype=None):
        """Per-layer (K, V) zeros [batch_size, max_length, H, D] on the
        model's device, in `dtype`, by default the model's (the paged pool
        calls this with (num_pages, page_size); see
        `LlamaForCausalLM.init_cache`)."""
        cfg = self.config
        w = self.word_embeddings.weight
        dt = w.dtype if dtype is None else to_torch_dtype(dtype)
        shape = (batch_size, int(max_length), cfg.num_attention_heads,
                 cfg.head_dim)
        return [(torch.zeros(shape, dtype=dt, device=w.device),
                 torch.zeros(shape, dtype=dt, device=w.device))
                for _ in range(cfg.num_hidden_layers)]


class GPTForCausalLM(Layer, GenerationMixin):
    """GPT with its LM head (tied to the word embeddings unless
    `tie_word_embeddings=False`). It implements the serving engine's
    model protocol (`forward(..., kv_pages=, table=, floor=)`,
    `prefill_kv`, `init_cache`, `device`, `dtype`) as `LlamaForCausalLM`
    does, and `GenerationMixin`'s `generate` / `speculative_generate`."""

    def __init__(self, config: GPTConfig, *, device=None, dtype='float32',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.gpt = GPTModel(config, device=device, dtype=dtype,
                            generator=generator)
        emb = self.gpt.word_embeddings.weight
        self.lm_head = None if config.tie_word_embeddings else Linear(
            config.hidden_size, config.vocab_size, bias_attr=False,
            device=emb.device, dtype=emb.dtype, generator=generator)

    @property
    def device(self) -> torch.device:
        return self.gpt.word_embeddings.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.gpt.word_embeddings.weight.dtype

    def _logits(self, h):
        if self.lm_head is not None:
            return self.lm_head(h)
        return torch.matmul(h, self.gpt.word_embeddings.weight.t())

    def forward(self, input_ids, position_offset=None, attention_mask=None,
                cache=None, use_cache=False, labels=None, cache_offset=None,
                kv_pages=None, table=None, floor=None):
        """Logits [B, S, V]; with `labels` [B, S] (loss, logits); with
        `use_cache` the updated caches come last."""
        h, kvs = self.gpt(input_ids, position_offset=position_offset,
                          attention_mask=attention_mask, cache=cache,
                          cache_offset=cache_offset, kv_pages=kv_pages,
                          table=table, floor=floor)
        logits = self._logits(h)
        out = (logits,) if labels is None else (F.cross_entropy(
            logits.reshape(-1, self.config.vocab_size), labels.reshape(-1)),
            logits)
        if use_cache:
            out = out + (kvs,)
        return out[0] if len(out) == 1 else out

    def prefill_kv(self, input_ids, start=None, kv_pages=None, table=None,
                   floor=None, kv_dtype=None) -> List[tuple]:
        """The serving engine's prefill, without logits (see
        `LlamaForCausalLM.prefill_kv`): each layer's (k, v) rows [B, S,
        H, D] of the causal forward from position 0, or with `kv_pages`
        the chunk forward at `start`, which writes its rows itself."""
        return self.gpt(input_ids, position_offset=start, kv_pages=kv_pages,
                        table=table, floor=floor, kv_dtype=kv_dtype)[1]

    def init_cache(self, batch_size: int, max_length: int, dtype=None):
        return self.gpt.init_cache(batch_size, max_length, dtype)


__all__ = ['GPTConfig', 'GPTAttention', 'GPTDecoderLayer', 'GPTModel',
           'GPTForCausalLM', 'split_qkv']
