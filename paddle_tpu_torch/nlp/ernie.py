"""The ERNIE family (counterpart of `paddle_tpu/nlp/ernie.py`): a BERT
encoder plus task-type embeddings, with the JAX package's `state_dict`
keys (`ernie.bert.*`, `ernie.task_type_embeddings.weight`)."""
from __future__ import annotations

from typing import Optional

import torch

from ..nn.common_layers import Dropout, Embedding, Linear
from ..nn import functional as F
from ..nn.layer import Layer, init_kwargs
from .bert import BertConfig, BertModel, _MaskedLMHead


class ErnieConfig(BertConfig):
    model_type = 'ernie'

    def __init__(self, task_type_vocab_size=3, use_task_id=True, **kwargs):
        super().__init__(**kwargs)
        self.task_type_vocab_size = task_type_vocab_size
        self.use_task_id = use_task_id


class ErnieModel(Layer):

    def __init__(self, config: ErnieConfig, add_pooling_layer: bool = True,
                 *, device=None, dtype='float32',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.bert = BertModel(config, add_pooling_layer=add_pooling_layer,
                              device=device, dtype=dtype, generator=generator)
        self.task_type_embeddings = Embedding(
            config.task_type_vocab_size, config.hidden_size,
            **init_kwargs(device, dtype, generator)) \
            if config.use_task_id else None

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, task_type_ids=None):
        task_emb = None
        if self.task_type_embeddings is not None:
            if task_type_ids is None:
                task_type_ids = torch.zeros_like(input_ids)
            task_emb = self.task_type_embeddings(task_type_ids)
        return self.bert(input_ids, token_type_ids=token_type_ids,
                         position_ids=position_ids,
                         attention_mask=attention_mask,
                         extra_embeds=task_emb)


class ErnieForMaskedLM(_MaskedLMHead):

    def __init__(self, config: ErnieConfig, *, device=None, dtype='float32',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.ernie = ErnieModel(config, add_pooling_layer=False,
                                device=device, dtype=dtype,
                                generator=generator)
        self._build_head(config, init_kwargs(device, dtype, generator))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                task_type_ids=None, labels=None):
        h = self.ernie(input_ids, token_type_ids=token_type_ids,
                       attention_mask=attention_mask,
                       task_type_ids=task_type_ids)
        return self._lm_out(h, labels)


class ErnieForSequenceClassification(Layer):

    def __init__(self, config: ErnieConfig, num_classes=None, *,
                 device=None, dtype='float32',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.num_classes = num_classes or config.num_labels
        self.ernie = ErnieModel(config, device=device, dtype=dtype,
                                generator=generator)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, self.num_classes,
                                 **init_kwargs(device, dtype, generator))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                task_type_ids=None, labels=None):
        _, pooled = self.ernie(input_ids, token_type_ids=token_type_ids,
                               attention_mask=attention_mask,
                               task_type_ids=task_type_ids)
        logits = self.classifier(self.dropout(pooled))
        if labels is None:
            return logits
        return F.cross_entropy(logits, labels), logits


__all__ = ['ErnieConfig', 'ErnieModel', 'ErnieForMaskedLM',
           'ErnieForSequenceClassification']
