"""The BERT family (counterpart of `paddle_tpu/nlp/bert.py`), with the
same `state_dict` keys and shapes: `BertConfig` (`bert_base`,
`bert_large`, `tiny`), `BertModel`, `BertForMaskedLM` and
`BertForSequenceClassification`.

The encoder is `nn.TransformerEncoder` of post-LN layers. A 2-D pad
mask becomes a boolean [B, 1, 1, S] mask (`paddle_tpu/nlp/bert.py:
150-155`) and takes the plain attention; an unmasked batch without
attention dropout takes the flash kernels (head_dim 64 at BERT-base and
BERT-large: the D = 64 instantiations on the card). The classification
and masked-LM losses go through `F.cross_entropy`, whose hard-label
[N, V] path is the CE kernels whatever V (the JAX package sends V <
8192 to XLA; the two agree to 1e-6 in f32).

`use_recompute` reruns each encoder layer in the backward through
`torch.utils.checkpoint` (non-reentrant), as the port's Llama does; the
rerun restores the framework generator's state first, so a layer's
dropout draws the masks of its forward. Random weights are Paddle's
defaults on `device` (default `cuda`, raising without a card) from
`generator`.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import amp as _amp
from .. import framework
from ..nn import functional as F
from ..nn.common_layers import Dropout, Embedding, Linear
from ..nn.layer import Layer, init_kwargs
from ..nn.norm import LayerNorm
from ..nn.transformer import TransformerEncoder, TransformerEncoderLayer
from .generation import pad_mask


class BertConfig:
    model_type = 'bert'

    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act='gelu',
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 initializer_range=0.02, layer_norm_eps=1e-12,
                 pad_token_id=0, pool_act='tanh', num_labels=2,
                 use_recompute=False, **kwargs):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.initializer_range = initializer_range
        self.layer_norm_eps = layer_norm_eps
        self.pad_token_id = pad_token_id
        self.pool_act = pool_act
        self.num_labels = num_labels
        self.use_recompute = use_recompute
        for k, v in kwargs.items():
            setattr(self, k, v)

    @classmethod
    def bert_base(cls, **kw):
        return cls(**kw)

    @classmethod
    def bert_large(cls, **kw):
        return cls(hidden_size=1024, num_hidden_layers=24,
                   num_attention_heads=16, intermediate_size=4096, **kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault('vocab_size', 128)
        kw.setdefault('hidden_size', 64)
        kw.setdefault('num_hidden_layers', 2)
        kw.setdefault('num_attention_heads', 4)
        kw.setdefault('intermediate_size', 128)
        kw.setdefault('max_position_embeddings', 128)
        kw.setdefault('hidden_dropout_prob', 0.0)
        kw.setdefault('attention_probs_dropout_prob', 0.0)
        return cls(**kw)


class BertEmbeddings(Layer):
    def __init__(self, config: BertConfig, **init):
        super().__init__()
        norm_init = {k: init[k] for k in ('device', 'dtype')}
        h = config.hidden_size
        self.word_embeddings = Embedding(config.vocab_size, h, **init)
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             h, **init)
        self.token_type_embeddings = Embedding(config.type_vocab_size, h,
                                               **init)
        self.layer_norm = LayerNorm(h, epsilon=config.layer_norm_eps,
                                    **norm_init)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                extra_embeds=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        h = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        if extra_embeds is not None:
            h = h + extra_embeds
        return self.dropout(self.layer_norm(h))


class BertPooler(Layer):
    def __init__(self, config: BertConfig, **init):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size, **init)
        self.activation = F.tanh if config.pool_act == 'tanh' else F.relu

    def forward(self, hidden):
        return self.activation(self.dense(hidden[:, 0]))


def _recomputed(layer, h, mask):
    """`layer(h, src_mask=mask)` under a non-reentrant checkpoint whose
    rerun draws the forward's dropout masks: it restores the framework
    generator's state from before the forward, then puts back the state
    it found."""
    gen = framework.default_generator(h.device)
    start = gen.get_state()
    calls = [0]

    def run(x):
        if calls[0] == 0:
            calls[0] = 1
            return layer(x, src_mask=mask)
        now = gen.get_state()
        gen.set_state(start)
        try:
            return layer(x, src_mask=mask)
        finally:
            gen.set_state(now)
    return checkpoint(_amp.keep_policy(run), h, use_reentrant=False)


class BertModel(Layer):

    def __init__(self, config: BertConfig, add_pooling_layer: bool = True,
                 *, device=None, dtype='float32',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        init = init_kwargs(device, dtype, generator)
        self.config = config
        self.embeddings = BertEmbeddings(config, **init)
        enc_layer = TransformerEncoderLayer(
            config.hidden_size, config.num_attention_heads,
            config.intermediate_size, dropout=config.hidden_dropout_prob,
            activation=config.hidden_act,
            attn_dropout=config.attention_probs_dropout_prob,
            normalize_before=False, layer_norm_eps=config.layer_norm_eps,
            **init)
        self.encoder = TransformerEncoder(enc_layer,
                                          config.num_hidden_layers)
        self.pooler = BertPooler(config, **init) if add_pooling_layer \
            else None

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, extra_embeds=None):
        """(sequence output [B, S, H], pooled [B, H]), or the sequence
        output alone without a pooler."""
        h = self.embeddings(input_ids, token_type_ids, position_ids,
                            extra_embeds=extra_embeds)
        mask = pad_mask(attention_mask)
        if self.config.use_recompute and torch.is_grad_enabled():
            for layer in self.encoder.layers:
                h = _recomputed(layer, h, mask)
        else:
            h = self.encoder(h, src_mask=mask)
        pooled = self.pooler(h) if self.pooler is not None else None
        return (h, pooled) if pooled is not None else h


class _MaskedLMHead(Layer):
    """transform -> gelu -> LayerNorm -> decoder, as the JAX heads."""

    def _build_head(self, config, init):
        norm_init = {k: init[k] for k in ('device', 'dtype')}
        self.transform = Linear(config.hidden_size, config.hidden_size,
                                **init)
        self.transform_norm = LayerNorm(config.hidden_size,
                                        epsilon=config.layer_norm_eps,
                                        **norm_init)
        self.decoder = Linear(config.hidden_size, config.vocab_size, **init)

    def _lm_out(self, h, labels):
        h = self.transform_norm(F.gelu(self.transform(h)))
        logits = self.decoder(h)
        if labels is None:
            return logits
        loss = F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                               labels.reshape(-1), ignore_index=-100)
        return loss, logits


class BertForMaskedLM(_MaskedLMHead):

    def __init__(self, config: BertConfig, *, device=None, dtype='float32',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.bert = BertModel(config, add_pooling_layer=False, device=device,
                              dtype=dtype, generator=generator)
        self._build_head(config, init_kwargs(device, dtype, generator))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        h = self.bert(input_ids, token_type_ids=token_type_ids,
                      attention_mask=attention_mask)
        return self._lm_out(h, labels)


class BertForSequenceClassification(Layer):

    def __init__(self, config: BertConfig, num_classes=None, *, device=None,
                 dtype='float32',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.num_classes = num_classes or config.num_labels
        self.bert = BertModel(config, add_pooling_layer=True, device=device,
                              dtype=dtype, generator=generator)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, self.num_classes,
                                 **init_kwargs(device, dtype, generator))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.bert(input_ids, token_type_ids=token_type_ids,
                              attention_mask=attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is None:
            return logits
        return F.cross_entropy(logits, labels), logits


__all__ = ['BertConfig', 'BertEmbeddings', 'BertPooler', 'BertModel',
           'BertForMaskedLM', 'BertForSequenceClassification']
