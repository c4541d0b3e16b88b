"""Import-path parity with the reference's `paddlenlp.transformers`
(counterpart of `paddle_tpu/nlp/transformers.py`): the models, both
generation mixins' hosts and the tokenizers."""
from .bert import (BertConfig, BertForMaskedLM,  # noqa: F401
                   BertForSequenceClassification, BertModel)
from .ernie import (ErnieConfig, ErnieForMaskedLM,  # noqa: F401
                    ErnieForSequenceClassification, ErnieModel)
from .generation import GenerationMixin, Seq2SeqGenerationMixin  # noqa: F401
from .gpt import GPTConfig, GPTForCausalLM, GPTModel  # noqa: F401
from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel  # noqa: F401
from .t5 import (T5Config, T5ForConditionalGeneration,  # noqa: F401
                 T5Model)
from .tokenizer import (BPETokenizer, PretrainedTokenizer,  # noqa: F401
                        WhitespaceTokenizer)

__all__ = ['BertConfig', 'BertForMaskedLM', 'BertForSequenceClassification',
           'BertModel', 'BPETokenizer', 'ErnieConfig', 'ErnieForMaskedLM',
           'ErnieForSequenceClassification', 'ErnieModel', 'GenerationMixin',
           'GPTConfig', 'GPTForCausalLM', 'GPTModel', 'LlamaConfig',
           'LlamaForCausalLM', 'LlamaModel', 'PretrainedTokenizer',
           'Seq2SeqGenerationMixin', 'T5Config',
           'T5ForConditionalGeneration', 'T5Model', 'WhitespaceTokenizer']
