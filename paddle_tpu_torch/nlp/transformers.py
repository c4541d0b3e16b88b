"""Import-path parity with the reference's `paddlenlp.transformers`
(counterpart of `paddle_tpu/nlp/transformers.py`). `T5*` and the
tokenizers wait for their slice (ROADMAP, Queue 1)."""
from .bert import (BertConfig, BertForMaskedLM,  # noqa: F401
                   BertForSequenceClassification, BertModel)
from .ernie import (ErnieConfig, ErnieForMaskedLM,  # noqa: F401
                    ErnieForSequenceClassification, ErnieModel)
from .generation import GenerationMixin  # noqa: F401
from .gpt import GPTConfig, GPTForCausalLM, GPTModel  # noqa: F401
from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel  # noqa: F401

__all__ = ['BertConfig', 'BertForMaskedLM', 'BertForSequenceClassification',
           'BertModel', 'ErnieConfig', 'ErnieForMaskedLM',
           'ErnieForSequenceClassification', 'ErnieModel', 'GenerationMixin',
           'GPTConfig', 'GPTForCausalLM', 'GPTModel', 'LlamaConfig',
           'LlamaForCausalLM', 'LlamaModel']
